"""matten_tpu_torch — the PyTorch + CUDA port of matten_tpu.

The JAX package `matten_tpu` stays the reference. This package mirrors its
layout (`ops/`, `nn/`, `kernels/`, `models/`, `predict.py`) so every module
has its counterpart at the same path. It imports torch and numpy, and of
`matten_tpu` only the numpy modules (irreps, wigner, elasticity and the data
graph / structure / neighbour-list / transform code); it never imports jax.

The fused uvu convolution (`kernels/fused_conv.py`) is a hand-written CUDA
kernel for Hopper (sm_90a), built with nvcc at first use.
"""

__version__ = "0.1.0"

from matten_tpu.ops.irreps import Irrep, Irreps

__all__ = ["Irrep", "Irreps", "__version__"]
