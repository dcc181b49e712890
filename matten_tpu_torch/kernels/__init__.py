"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions,
and the tier switch (`fused_tp`). Nothing is built or loaded until a kernel
is first launched."""

from matten_tpu_torch.kernels.fused_conv import fused_uvu_conv
from matten_tpu_torch.kernels.fused_tp import get_tp_impl, set_tp_impl

__all__ = ["fused_uvu_conv", "set_tp_impl", "get_tp_impl"]
