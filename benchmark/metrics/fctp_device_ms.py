"""Species FCTPs (`nn/conv.py::PointConv.species_fctp`,
`ops/tensor_product.py`: the sc, lin1 and lin2 products of every conv
layer): the device ms of the program's "fctp" and "bwd.fctp" layer marks
inside the train steps' graphs in the spanned epochs (`spanned.py`), per
train step. None unless every spanned step was a graph replay. Moves the
cell's training rate."""

from benchmark import spanned


def read(span):
    s = spanned.result(span)
    layers = {} if s is None else s.layer_ms()
    if "fctp" not in layers:
        return None
    return layers["fctp"] + layers.get("bwd.fctp", 0.0)
