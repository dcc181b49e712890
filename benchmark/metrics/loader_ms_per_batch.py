"""Data module (`data/datamodule.py::BatchLoader`, `data/graph.py::collate_graphs`):
the mean host ms of one `next()` of the train loader that `fit` iterates
in the untraced epochs, the benchmark's own span around each call. Moves
the cell's training rate."""


def read(span):
    if not span.loader_s:
        return None
    return 1e3 * sum(span.loader_s) / len(span.loader_s)
