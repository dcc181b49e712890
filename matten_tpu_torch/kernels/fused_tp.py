"""Kernel-tier configuration: the conv's implementation and its edge
inputs' storage dtype.

Counterpart of `matten_tpu/kernels/fused_tp.py`, with its names, so that one
environment drives both packages:

  * `set_tp_impl("pallas" | "xla")`: "pallas" (the default) runs the
    hand-written CUDA kernels on CUDA tensors, "xla" the kernels' plain
    PyTorch versions (`kernels.fused_conv.force_plain` sets it for a block).
    CPU tensors always take the plain versions. It is a switch the caller
    sets on purpose, not a fallback: a kernel that fails to build or launch
    raises.
  * `set_kernel_in_dtype("float32" | "bfloat16")`: the storage dtype of the
    conv's per-edge inputs sh and w (x, the cotangent, the arithmetic and
    every output stay float32).
  * `configure_default_tiers()`: the train scripts' selection from
    `MATTEN_TP_IMPL`. `MATTEN_AGG_DTYPE` is not read: it sets the operand
    dtype of the TPU kernels' one-hot aggregation matmuls, and the CUDA
    kernels sum into the nodes with a segment sum instead.
"""

from __future__ import annotations

import logging
import os

__all__ = [
    "set_tp_impl",
    "get_tp_impl",
    "set_kernel_in_dtype",
    "get_kernel_in_dtype",
    "configure_default_tiers",
]

logger = logging.getLogger(__name__)

_TP_IMPL = "pallas"  # "pallas": the CUDA kernels | "xla": the plain versions
_KERNEL_IN_DTYPE = "float32"  # "float32" | "bfloat16" (storage of sh and w)


def set_tp_impl(impl: str) -> None:
    """Select the conv's implementation on CUDA tensors globally."""
    global _TP_IMPL
    if impl not in ("xla", "pallas"):
        raise ValueError(f"tp impl {impl!r} not in ('xla', 'pallas')")
    _TP_IMPL = impl


def get_tp_impl() -> str:
    return _TP_IMPL


def set_kernel_in_dtype(name: str) -> None:
    """Storage dtype of the conv's edge inputs sh and w.

    bfloat16 halves the kernels' reads of the per-edge arrays (w [E, dw]
    dominates); the values are rounded to nearest even once, and compute
    and accumulation stay float32. Validate training quality before
    enabling it in production runs."""
    global _KERNEL_IN_DTYPE
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"kernel input dtype {name!r} not in ('float32', 'bfloat16')")
    _KERNEL_IN_DTYPE = name


def get_kernel_in_dtype() -> str:
    return _KERNEL_IN_DTYPE


def configure_default_tiers() -> str:
    """Entry-point tier selection (the train scripts):

      MATTEN_TP_IMPL = pallas | xla   (default: pallas, the kernels on CUDA
                                       tensors)

    Returns the selected impl. An explicit xla is logged, since every conv
    then runs its plain version on the card."""
    impl = os.environ.get("MATTEN_TP_IMPL", "pallas")
    set_tp_impl(impl)
    if impl == "xla":
        logger.info("MATTEN_TP_IMPL=xla: the conv runs its plain PyTorch version, not the CUDA kernels")
    return impl
