"""Spherical-harmonic edge attributes from precomputed edge vectors.

Counterpart of `matten_tpu/nn/edge_geometry.py` for the serving path:
collation (`matten_tpu_torch.data.graph.collate_graphs`) attaches EDGE_VECTORS
host-side, vec = pos[dst] - pos[src] + shift @ cell, zero on padding edges.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.nn.common import merge_irreps
from matten_tpu_torch.ops.spherical_harmonics import spherical_harmonics


def with_edge_vectors(data: Dict[str, torch.Tensor]) -> None:
    """Attach EDGE_LENGTH in place from the precomputed EDGE_VECTORS."""
    if K.EDGE_VECTORS not in data:
        raise ValueError(
            "EDGE_VECTORS missing: collate with precompute_edge_vectors=True"
        )
    if K.EDGE_LENGTH not in data:
        data[K.EDGE_LENGTH] = torch.linalg.norm(data[K.EDGE_VECTORS], dim=-1)


class SphericalHarmonicEdgeAttrs(torch.nn.Module):
    """edge_attrs = Y_l(r_hat) for l in `irreps_edge_sh` (component norm),
    zeroed on padding edges (Y_0 would be 1)."""

    def __init__(self, irreps_in: Mapping, irreps_edge_sh: Irreps):
        super().__init__()
        self.irreps_in = dict(irreps_in)
        self.irreps_edge_sh = Irreps(irreps_edge_sh)
        self.irreps_out = merge_irreps(self.irreps_in, {K.EDGE_ATTRS: self.irreps_edge_sh})

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        with_edge_vectors(data)
        sh = spherical_harmonics(self.irreps_edge_sh, data[K.EDGE_VECTORS])
        if K.EDGE_MASK in data:
            sh = sh * data[K.EDGE_MASK][:, None].to(sh.dtype)
        data[K.EDGE_ATTRS] = sh
        return data
