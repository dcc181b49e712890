"""matten_tpu_torch — the PyTorch + CUDA port of matten_tpu.

The JAX package `matten_tpu` stays the reference. This package mirrors its
layout (`ops/`, `data/`, `nn/`, `kernels/`, `models/`, `train/`,
`predict.py`) so every module has its counterpart at the same path. It
imports torch and numpy and nothing of `matten_tpu` or of JAX: the numpy
modules it shares with the JAX package (irreps, wigner, elasticity, and the
data keys / structure / neighbour-list / graph / transform code) are copies
of its own, and the host neighbour-list library is built from
`data/csrc/` into `_build/`.

The fused uvu convolution and its gradient (`kernels/fused_conv.py`) are
hand-written CUDA kernels for Hopper (sm_90a), built with nvcc at first use.
Entry points run on the card unless the caller passes another device.
"""

__version__ = "0.1.0"

from matten_tpu_torch.ops.irreps import Irrep, Irreps

__all__ = ["Irrep", "Irreps", "__version__"]
