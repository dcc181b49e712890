"""Step graphs (`train/graphs.py::StepGraphs.run`): the seconds of the
program's "graphs.first_sight" (a pad shape's first step, eager) and
"graphs.capture" spans in set-up, which the traced run shares with the
window (`spanned.py`), less the kernels' build and load inside them (the
"kernels.load" span: the first run in a checkout compiles them in its
first step). None where set-up captured no graph. Moves `setup_s`."""

from benchmark import spanned


def read(span):
    s = spanned.result(span)
    return None if s is None else s.setup_s
