"""Step graphs (`train/graphs.py`): `cudaGraphLaunch` calls in the traced
epochs per train and eval step the benchmark counted there, in percent; a
step that runs eagerly or is captured inside the span lowers it. Moves
the cell's training rate."""


def read(span):
    steps = len(span.traced["train"]) + len(span.traced["val"])
    if not steps:
        return None
    return 100.0 * span.trace.graph_launches / steps
