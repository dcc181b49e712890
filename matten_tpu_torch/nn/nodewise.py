"""Node-wise linear map, masked per-graph pooling and node selection.

Counterpart of `matten_tpu/nn/nodewise.py` (NodewiseLinear, NodewiseReduce
with sum / mean / min / max, NodewiseSelect).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.nn.common import merge_irreps, normal_parameter
from matten_tpu_torch.ops.scatter import scatter_max, scatter_min, scatter_sum
from matten_tpu_torch.ops.tensor_product import LinearPlan
from matten_tpu_torch.parallel.collectives import pmax, pmin, psum
from matten_tpu_torch.parallel.sharding import bound_axis


class NodewiseLinear(torch.nn.Module):
    """Equivariant linear map on a node field (e3nn o3.Linear, no bias)."""

    MARK = "head"  # its device time's name (`nn.sequential.Sequential`)

    def __init__(
        self,
        irreps_in: Mapping,
        irreps_out_field: Irreps,
        generator: torch.Generator,
        field: str = K.NODE_FEATURES,
        out_field: Optional[str] = None,
    ):
        super().__init__()
        self.field = field
        self.out_field = out_field if out_field is not None else field
        self.irreps_in = dict(irreps_in)
        self.irreps_out = merge_irreps(self.irreps_in, {self.out_field: Irreps(irreps_out_field)})
        self.plan = LinearPlan(Irreps(self.irreps_in[field]), Irreps(irreps_out_field))
        self.w = normal_parameter(self.plan.weight_numel, generator)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        data[self.out_field] = self.plan.apply(data[self.field], self.w)
        return data


class NodewiseReduce(torch.nn.Module):
    """Masked segment sum / mean / min / max of a node field into per-graph
    features; padded nodes are excluded through the node mask. min / max
    give padded rows the +/-inf sentinel before the segment reduction, and
    a graph with no real node (an all-padding graph) gets 0. With `axis`,
    the graph axis of a node-sharded model, a graph's nodes may lie on
    several ranks: the per-graph sums and counts are summed over the axis
    (sum, mean), the per-graph extremes reduced by pmin / pmax (min, max)."""

    MARK = "head"  # its device time's name (`nn.sequential.Sequential`)

    def __init__(
        self,
        irreps_in: Mapping,
        field: str = K.NODE_FEATURES,
        out_field: Optional[str] = None,
        reduce: str = "sum",
        axis: Optional[str] = None,
    ):
        super().__init__()
        if reduce not in ("sum", "mean", "min", "max"):
            raise ValueError(f"unsupported reduce {reduce!r}")
        self.field = field
        self.reduce = reduce
        self.axis = axis
        self.out_field = out_field if out_field is not None else f"{reduce}_{field}"
        self.irreps_in = dict(irreps_in)
        self.irreps_out = merge_irreps(self.irreps_in, {self.out_field: self.irreps_in[field]})

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        x = data[self.field]
        num_graphs = data[K.CELL].reshape(-1, 3, 3).shape[0]
        mask = data.get(K.NODE_MASK)
        axis = None if self.axis is None else bound_axis(data, self.axis)
        if self.reduce in ("sum", "mean"):
            w = x.new_ones(x.shape[0]) if mask is None else mask.to(x.dtype)
            out = psum(scatter_sum(x * w[:, None], data[K.BATCH], num_graphs), axis)
            if self.reduce == "mean":
                out = out / psum(scatter_sum(w, data[K.BATCH], num_graphs), axis).clamp_min(1.0)[:, None]
        else:
            if mask is not None:
                sentinel = float("inf") if self.reduce == "min" else float("-inf")
                x = x.masked_fill(~mask.bool()[:, None], sentinel)
            red, across = (scatter_min, pmin) if self.reduce == "min" else (scatter_max, pmax)
            out = across(red(x, data[K.BATCH], num_graphs), axis)
            out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
        data[self.out_field] = out
        return data


class NodewiseSelect(torch.nn.Module):
    """Zero a node field outside a boolean per-node selector (e.g.
    atom_selector), at the field's shape; losses and metrics reduce over
    the same mask."""

    def __init__(
        self,
        irreps_in: Mapping,
        field: str = K.NODE_FEATURES,
        out_field: Optional[str] = None,
        mask_field: str = K.ATOM_SELECTOR,
    ):
        super().__init__()
        self.field = field
        self.mask_field = mask_field
        self.out_field = out_field if out_field is not None else f"selected_{field}"
        self.irreps_in = dict(irreps_in)
        self.irreps_out = merge_irreps(self.irreps_in, {self.out_field: self.irreps_in[field]})

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        x = data[self.field]
        data[self.out_field] = x * data[self.mask_field][:, None].to(x.dtype)
        return data
