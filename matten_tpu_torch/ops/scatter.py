"""Segment (scatter) reductions with explicit segment counts, via index_add_.

Counterpart of `matten_tpu/ops/scatter.py` (sum and mean).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["scatter_sum", "scatter_mean"]


def scatter_sum(src: torch.Tensor, index: torch.Tensor, dim_size: int) -> torch.Tensor:
    out = src.new_zeros((dim_size,) + src.shape[1:])
    return out.index_add_(0, index.long(), src)


def scatter_mean(
    src: torch.Tensor,
    index: torch.Tensor,
    dim_size: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked segment mean: optional per-element weights (e.g. a validity
    mask) apply to both numerator and denominator."""
    if weights is not None:
        w = weights.to(src.dtype)
    else:
        w = src.new_ones(src.shape[0])
    num = scatter_sum(src * w.reshape(w.shape + (1,) * (src.ndim - 1)), index, dim_size)
    den = scatter_sum(w, index, dim_size).clamp_min(1.0)
    return num / den.reshape(den.shape + (1,) * (src.ndim - 1))
