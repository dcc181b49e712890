"""Fit loop feed (`train/trainer.py::Trainer._device_group`: the host
check, stack, pin and copy of each group): the program's "fit.feed" spans
in the spanned epochs (`spanned.py`), less their child spans, in ms per
train step; the validation's feeds count in. None unless every spanned
step was a graph replay. Moves the cell's training rate."""

from benchmark import spanned


def read(span):
    s = spanned.result(span)
    return None if s is None else s.per_step_ms("fit.feed", own=True)
