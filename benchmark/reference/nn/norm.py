"""Irreps-aware batch and instance normalization, mask-aware for padded
graphs.

Counterpart of `matten_tpu/nn/norm.py`. `IrrepsBatchNorm` (e3nn BatchNorm
semantics): per-irrep-channel statistics, mean subtraction for scalars only,
second-moment ("component") normalization for every channel, running
statistics with momentum, affine weight (+ bias for scalars). Statistics
exclude padded nodes through the node mask. In `eval()` mode the running
statistics are used; in `train()` mode batch statistics are used and the
running ones updated. With `axis`, the graph axis of a node-sharded
model, the sums behind the batch statistics (and their node count) are
summed over the axis first, so every rank of a graph normalizes with the
statistics of all its nodes. `IrrepsInstanceNorm`: the same per channel, with
each graph's statistics over its real nodes, in both modes, and no running
statistics.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from benchmark.reference.ops.irreps import Irreps
from benchmark.reference.single import psum
from benchmark.reference.single import bound_axis

__all__ = ["IrrepsBatchNorm", "IrrepsInstanceNorm"]


def _channel_maps(irreps: Irreps):
    """(comp2feat [D], scal_comp [S], dims [F]): the feature channel of each
    component, the scalar components and each channel's dimension; channels
    are (entry, mul) pairs in entry order."""
    comp2feat, scal_comp, feat_base, comp_base = [], [], 0, 0
    for mul, ir in irreps:
        comp2feat.append(np.repeat(feat_base + np.arange(mul), ir.dim))
        if ir.l == 0:
            scal_comp.append(comp_base + np.arange(mul))
        feat_base += mul
        comp_base += mul * ir.dim
    comp2feat = np.concatenate(comp2feat)
    scal_comp = np.concatenate(scal_comp) if scal_comp else np.zeros(0, np.int64)
    return comp2feat, scal_comp, np.bincount(comp2feat, minlength=irreps.num_irreps)


class IrrepsBatchNorm(torch.nn.Module):
    EPS = 1e-5
    MOMENTUM = 0.1

    def __init__(self, irreps: Irreps, axis: Optional[str] = None):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.axis = axis
        num_scalars = sum(mul for mul, ir in self.irreps if ir.l == 0)
        num_features = self.irreps.num_irreps
        comp2feat, scal_comp, dims = _channel_maps(self.irreps)

        self.register_buffer("comp2feat", torch.as_tensor(comp2feat), persistent=False)
        self.register_buffer("scal_comp", torch.as_tensor(scal_comp), persistent=False)
        self.register_buffer(
            "inv_dim", torch.as_tensor(1.0 / dims, dtype=torch.float32), persistent=False
        )
        self.register_buffer("running_mean", torch.zeros(num_scalars))
        self.register_buffer("running_var", torch.ones(num_features))
        self.weight = torch.nn.Parameter(torch.ones(num_features))
        self.bias = torch.nn.Parameter(torch.zeros(num_scalars))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                data: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        """`data`, the batch dict, carries the mesh of a node-sharded model."""
        m = x.new_ones(x.shape[0]) if mask is None else mask.to(x.dtype)
        if self.training:
            axis = None if self.axis is None else bound_axis(data or {}, self.axis)
            count = psum(m.sum(), axis).clamp_min(1.0)
            fmean = psum((x[:, self.scal_comp] * m[:, None]).sum(0), axis) / count
        else:
            fmean = self.running_mean.to(x.dtype)
        mean_comp = x.new_zeros(x.shape[-1]).index_copy(0, self.scal_comp, fmean)
        xc = x - mean_comp

        if self.training:
            sq = psum(((xc * xc) * m[:, None]).sum(0), axis)
            fnorm = x.new_zeros(self.running_var.shape[0]).index_add(0, self.comp2feat, sq)
            fnorm = fnorm * self.inv_dim.to(x.dtype) / count
        else:
            fnorm = self.running_var.to(x.dtype)
        factor = self.weight.to(x.dtype) / torch.sqrt(fnorm + self.EPS)
        out = xc * factor[self.comp2feat]
        if self.scal_comp.numel():
            out = out.index_add(1, self.scal_comp, self.bias.to(x.dtype).expand(x.shape[0], -1))

        if self.training:
            with torch.no_grad():
                if self.scal_comp.numel():
                    self.running_mean.lerp_(fmean.detach(), self.MOMENTUM)
                self.running_var.lerp_(fnorm.detach(), self.MOMENTUM)
        return out


class IrrepsInstanceNorm(torch.nn.Module):
    """Per-graph irreps norm: statistics over each graph's real nodes (the
    node mask weighs the means). A graph without real nodes has count 0,
    clamped to 1, so its statistics are 0 and its factor 1/sqrt(eps):
    finite, and its (padded) rows are masked by the caller.

    The per-graph sums are products with the [N, G] masked one-hot of
    `batch`, and the per-channel mean squares a product with a [D, F]
    averaging matrix: a fixed summation order (no atomics on the card, so
    two runs are bitwise equal) and a few launches for all channels."""

    EPS = 1e-5

    def __init__(self, irreps: Irreps):
        super().__init__()
        self.irreps = Irreps(irreps)
        comp2feat, scal_comp, dims = _channel_maps(self.irreps)
        msq = np.zeros((comp2feat.shape[0], self.irreps.num_irreps), dtype=np.float32)
        msq[np.arange(comp2feat.shape[0]), comp2feat] = 1.0 / dims[comp2feat]
        self.register_buffer("comp2feat", torch.as_tensor(comp2feat), persistent=False)
        self.register_buffer("scal_comp", torch.as_tensor(scal_comp), persistent=False)
        self.register_buffer("msq", torch.as_tensor(msq), persistent=False)
        self.weight = torch.nn.Parameter(torch.ones(self.irreps.num_irreps))
        self.bias = torch.nn.Parameter(torch.zeros(scal_comp.shape[0]))

    def forward(
        self,
        x: torch.Tensor,
        batch: torch.Tensor,
        num_graphs: int,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        batch = batch.long()
        graphs = torch.arange(num_graphs, device=x.device)
        onehot = (batch[:, None] == graphs[None, :]).to(x.dtype)  # [N, G]
        if mask is not None:
            onehot = onehot * mask[:, None].to(x.dtype)
        count = onehot.sum(0).clamp_min(1.0)[:, None]
        mean = (onehot.T @ x[:, self.scal_comp]) / count  # [G, S]
        xc = x - x.new_zeros(x.shape).index_copy(1, self.scal_comp, mean[batch])
        fnorm = (onehot.T @ ((xc * xc) @ self.msq.to(x.dtype))) / count  # [G, F]
        factor = self.weight.to(x.dtype) / torch.sqrt(fnorm + self.EPS)
        out = xc * factor[batch][:, self.comp2feat]
        return out + x.new_zeros(x.shape[-1]).index_copy(0, self.scal_comp, self.bias.to(x.dtype))
