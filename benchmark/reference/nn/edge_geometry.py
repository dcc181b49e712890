"""Edge displacement vectors and spherical-harmonic edge attributes.

Counterpart of `matten_tpu/nn/edge_geometry.py`. Collation
(`benchmark.reference.data.graph.collate_graphs`) attaches EDGE_VECTORS
host-side by default, vec = pos[dst] - pos[src] + shift @ cell, zero on
padding edges; batches collated with `precompute_edge_vectors=False` get
the same vectors in the graph, differentiable with respect to POSITIONS and
CELL. Under the node-sharded graph modes the edges' src ids are global and
their dst ids local: `gather_axis` all-gathers the positions over the
graph axis into POS_FULL, which the src side indexes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from benchmark.reference.data import keys as K
from benchmark.reference.ops.irreps import Irreps
from benchmark.reference.nn.common import merge_irreps
from benchmark.reference.ops.spherical_harmonics import spherical_harmonics
from benchmark.reference.single import all_gather
from benchmark.reference.single import bound_axis


def with_edge_vectors(data: Dict[str, torch.Tensor], require_position_gradients: bool = False) -> None:
    """Attach EDGE_VECTORS and EDGE_LENGTH in place (idempotent).

    vec(e) = pos[dst] - pos[src] + shift(e) @ cell[batch[dst]], with src =
    edge_index[0] and dst = edge_index[1], zero on padding edges. Vectors
    precomputed at collation are constants with respect to the positions:
    with `require_position_gradients` their presence raises, so a model that
    needs d(output)/d(pos) is trained on batches collated with
    `precompute_edge_vectors=False`."""
    if K.EDGE_VECTORS in data:
        if require_position_gradients:
            raise ValueError(
                "precomputed EDGE_VECTORS are constants w.r.t. positions, but "
                "this model requires position gradients "
                "(require_position_gradients=True). Set the datamodule knob "
                "precompute_edge_vectors=false so edge vectors are computed "
                "in-graph from POSITIONS."
            )
        if K.EDGE_LENGTH not in data:
            data[K.EDGE_LENGTH] = torch.linalg.norm(data[K.EDGE_VECTORS], dim=-1)
        return
    pos = data[K.POSITIONS]
    src, dst = data[K.EDGE_INDEX].long()
    # node-sharded layouts: src ids index the gathered positions
    vec = pos[dst] - data.get(K.POS_FULL, pos)[src]
    if K.CELL in data:
        cell = data[K.CELL].reshape(-1, 3, 3)
        shift = data[K.EDGE_CELL_SHIFT]
        if cell.shape[0] > 1:
            # edges stay within one graph: batch[dst] == batch[src]
            vec = vec + torch.einsum("ei,eij->ej", shift, cell[data[K.BATCH].long()[dst]])
        else:
            vec = vec + shift @ cell[0]
    if K.EDGE_MASK in data:
        vec = vec * data[K.EDGE_MASK][:, None].to(vec.dtype)
    data[K.EDGE_VECTORS] = vec
    data[K.EDGE_LENGTH] = torch.linalg.norm(vec, dim=-1)


def gather_positions(data: Dict[str, torch.Tensor], axis_name: Optional[str]) -> None:
    """Attach POS_FULL in place, the positions all-gathered over the graph
    axis `axis_name` (node-sharded layouts); nothing without an axis, or
    when the batch has them or its edge vectors already."""
    if axis_name is None or K.POS_FULL in data or K.EDGE_VECTORS in data:
        return
    data[K.POS_FULL] = all_gather(data[K.POSITIONS], bound_axis(data, axis_name))


class SphericalHarmonicEdgeAttrs(torch.nn.Module):
    """edge_attrs = Y_l(r_hat) for l in `irreps_edge_sh` (component norm),
    zeroed on padding edges (Y_0 would be 1). `require_position_gradients`
    refuses precomputed edge vectors (see `with_edge_vectors`);
    `gather_axis` names the graph axis of a node-sharded model
    (`gather_positions`)."""

    def __init__(self, irreps_in: Mapping, irreps_edge_sh: Irreps, require_position_gradients: bool = False,
                 gather_axis: Optional[str] = None):
        super().__init__()
        self.irreps_in = dict(irreps_in)
        self.irreps_edge_sh = Irreps(irreps_edge_sh)
        self.require_position_gradients = bool(require_position_gradients)
        self.gather_axis = gather_axis
        self.irreps_out = merge_irreps(self.irreps_in, {K.EDGE_ATTRS: self.irreps_edge_sh})

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        gather_positions(data, self.gather_axis)
        with_edge_vectors(data, self.require_position_gradients)
        sh = spherical_harmonics(self.irreps_edge_sh, data[K.EDGE_VECTORS])
        if K.EDGE_MASK in data:
            sh = sh * data[K.EDGE_MASK][:, None].to(sh.dtype)
        data[K.EDGE_ATTRS] = sh
        return data
