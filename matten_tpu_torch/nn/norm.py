"""Irreps-aware batch normalization, mask-aware for padded graphs.

Counterpart of `matten_tpu/nn/norm.py::IrrepsBatchNorm` (e3nn BatchNorm
semantics): per-irrep-channel statistics, mean subtraction for scalars only,
second-moment ("component") normalization for every channel, running
statistics with momentum, affine weight (+ bias for scalars). Statistics
exclude padded nodes through the node mask. In `eval()` mode the running
statistics are used; in `train()` mode batch statistics are used and the
running ones updated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matten_tpu_torch.ops.irreps import Irreps

__all__ = ["IrrepsBatchNorm"]


class IrrepsBatchNorm(torch.nn.Module):
    EPS = 1e-5
    MOMENTUM = 0.1

    def __init__(self, irreps: Irreps):
        super().__init__()
        self.irreps = Irreps(irreps)
        num_scalars = sum(mul for mul, ir in self.irreps if ir.l == 0)
        num_features = self.irreps.num_irreps

        # component <-> feature-channel maps; channels are (entry, mul)
        # pairs in entry order, scalar components come first
        comp2feat, scal_comp, feat_base, comp_base = [], [], 0, 0
        for mul, ir in self.irreps:
            comp2feat.append(np.repeat(feat_base + np.arange(mul), ir.dim))
            if ir.l == 0:
                scal_comp.append(comp_base + np.arange(mul))
            feat_base += mul
            comp_base += mul * ir.dim
        comp2feat = np.concatenate(comp2feat)
        scal_comp = np.concatenate(scal_comp) if scal_comp else np.zeros(0, np.int64)
        dims = np.bincount(comp2feat, minlength=num_features)

        self.register_buffer("comp2feat", torch.as_tensor(comp2feat), persistent=False)
        self.register_buffer("scal_comp", torch.as_tensor(scal_comp), persistent=False)
        self.register_buffer(
            "inv_dim", torch.as_tensor(1.0 / dims, dtype=torch.float32), persistent=False
        )
        self.register_buffer("running_mean", torch.zeros(num_scalars))
        self.register_buffer("running_var", torch.ones(num_features))
        self.weight = torch.nn.Parameter(torch.ones(num_features))
        self.bias = torch.nn.Parameter(torch.zeros(num_scalars))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        m = x.new_ones(x.shape[0]) if mask is None else mask.to(x.dtype)
        count = m.sum().clamp_min(1.0)
        if self.training:
            fmean = (x[:, self.scal_comp] * m[:, None]).sum(0) / count
        else:
            fmean = self.running_mean.to(x.dtype)
        mean_comp = x.new_zeros(x.shape[-1]).index_copy(0, self.scal_comp, fmean)
        xc = x - mean_comp

        if self.training:
            sq = ((xc * xc) * m[:, None]).sum(0)
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
