"""Segment (scatter) reductions with explicit segment counts: sums via
index_add_, extrema via scatter_reduce.

Counterpart of `matten_tpu/ops/scatter.py`.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["scatter_sum", "scatter_mean", "scatter_max", "scatter_min"]


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


def _scatter_extremum(src: torch.Tensor, index: torch.Tensor, dim_size: int, reduce: str) -> torch.Tensor:
    """Segment max or min; a segment without elements holds the reduction's
    identity (-inf for max, +inf for min), as `jax.ops.segment_max/min`.
    The gradient is spread evenly over tied extrema, as in JAX."""
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = src.new_full((dim_size,) + src.shape[1:], fill)
    idx = index.long().reshape((-1,) + (1,) * (src.ndim - 1)).expand_as(src)
    return out.scatter_reduce(0, idx, src, reduce, include_self=False)


def scatter_max(src: torch.Tensor, index: torch.Tensor, dim_size: int) -> torch.Tensor:
    return _scatter_extremum(src, index, dim_size, "amax")


def scatter_min(src: torch.Tensor, index: torch.Tensor, dim_size: int) -> torch.Tensor:
    return _scatter_extremum(src, index, dim_size, "amin")
