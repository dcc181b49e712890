"""The benchmark's plain reference: a frozen copy of the port's plain path
(`ops/`, `nn/`, `models/tfn.py`, the numpy side of `data/`, the loss of
`train/task.py`), float32, with no kernel, no mesh and no step graph. It
imports neither the port nor JAX, so no change to the port moves it.
`single.py` stands for the port's kernels and collectives on one device."""
