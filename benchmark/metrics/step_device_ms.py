"""Train step (`train/trainer.py::train_step`, `models/tfn.py`, `nn/*`,
`ops/tensor_product.py`): the device's busy union over the traced epochs
(every kernel, copy and set of their train and eval steps) per train
step, in ms. Moves the cell's training rate."""


def read(span):
    if not span.traced["train"] or span.trace.busy_s <= 0:
        return None
    return 1e3 * span.trace.busy_s / len(span.traced["train"])
