"""Fit loop epoch end (`train/trainer.py::Trainer.fit` from the
validation's end to the epoch's end: the plateau scheduler, `set_lr`, the
history record): the program's "fit.epoch_end" spans in the spanned
epochs (`spanned.py`) less their child spans (the host reads that wait
for the card, "fit.sync", and the tracer's own read of its marks), in ms
per train step. None unless every spanned step was a graph replay. Moves
the cell's training rate."""

from benchmark import spanned


def read(span):
    s = spanned.result(span)
    return None if s is None else s.per_step_ms("fit.epoch_end", own=True)
