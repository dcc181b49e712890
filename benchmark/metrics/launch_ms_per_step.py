"""Step graphs (`train/graphs.py::_Captured.replay`: the static inputs'
copies, the graph's launch and the outputs' copies): the program's
"graphs.replay" spans in the spanned epochs (`spanned.py`), train and eval
steps, in ms per train step. None unless every spanned step was a graph
replay. Moves the cell's training rate."""

from benchmark import spanned


def read(span):
    s = spanned.result(span)
    return None if s is None else s.per_step_ms("graphs.replay")
