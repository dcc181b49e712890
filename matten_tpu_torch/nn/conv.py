"""TFN point convolution — the message-passing core.

Counterpart of `matten_tpu/nn/conv.py` (single device): self-connection and
node-wise mixing are species-conditioned fully-connected tensor products;
the per-edge message is a radial-MLP-weighted uvu CG tensor product of the
source features with the edge spherical harmonics, summed into the
destination nodes by the fused conv (K1) and normalized by
sqrt(avg num neighbors). Padding edges carry zero SH and zero radial
weights, so they deposit nothing.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.kernels.fused_conv import edge_plan, fused_uvu_conv
from matten_tpu_torch.nn.common import check_required, merge_irreps, normal_parameter
from matten_tpu_torch.nn.gate import ActivationInfo
from matten_tpu_torch.nn.norm import IrrepsBatchNorm, IrrepsInstanceNorm
from matten_tpu_torch.nn.radial import ScalarMLP
from matten_tpu_torch.ops.tensor_product import (
    TensorProductPlan,
    fully_connected_tp_plan,
    uvu_tp_plan,
)


# the conv kernels' edge plan (`kernels.fused_conv.EdgePlan`: the checked
# edges, the dst CSR, K1's items and, when gradients are recorded, the src
# order of the backward) in the batch dict: built on the card by the first
# PointConv of a forward, with the forward's one host sync, and read by the
# others, which share the edges
EDGE_PLAN = "edge_plan"


@functools.lru_cache(maxsize=None)
def _conv_plans(
    feats_in: Irreps, attrs: Irreps, edge_attrs: Irreps, conv_out: Irreps
) -> Tuple[TensorProductPlan, TensorProductPlan, TensorProductPlan, TensorProductPlan]:
    """(sc, lin1, uvu, lin2) plans for a PointConv layer (cached)."""
    sc = fully_connected_tp_plan(feats_in, attrs, conv_out)
    lin1 = fully_connected_tp_plan(feats_in, attrs, feats_in)
    uvu = uvu_tp_plan(feats_in, edge_attrs, conv_out)
    lin2 = fully_connected_tp_plan(uvu.irreps_out.simplify(), attrs, conv_out)
    return sc, lin1, uvu, lin2


class PointConv(torch.nn.Module):
    """TFN point convolution (single device)."""

    REQUIRED = (K.NODE_FEATURES, K.NODE_ATTRS, K.EDGE_ATTRS, K.EDGE_EMBEDDING)

    def __init__(
        self,
        irreps_in: Mapping,
        conv_layer_irreps: Irreps,
        generator: torch.Generator,
        fc_num_hidden_layers: int = 1,
        fc_hidden_size: int = 8,
        avg_num_neighbors: Optional[float] = None,
    ):
        super().__init__()
        check_required(irreps_in, self.REQUIRED, type(self).__name__)
        self.irreps_in = dict(irreps_in)
        self.conv_layer_irreps = Irreps(conv_layer_irreps)
        self.irreps_out = merge_irreps(self.irreps_in, {K.NODE_FEATURES: self.conv_layer_irreps})
        self.avg_num_neighbors = avg_num_neighbors
        self.sc_plan, self.lin1_plan, self.uvu_plan, self.lin2_plan = _conv_plans(
            Irreps(self.irreps_in[K.NODE_FEATURES]),
            Irreps(self.irreps_in[K.NODE_ATTRS]),
            Irreps(self.irreps_in[K.EDGE_ATTRS]),
            self.conv_layer_irreps,
        )
        self._onehot_attrs = all(
            p.in2_is_onehot_compatible for p in (self.sc_plan, self.lin1_plan, self.lin2_plan)
        )
        self.w_sc = normal_parameter(self.sc_plan.weight_numel, generator)
        self.w_lin1 = normal_parameter(self.lin1_plan.weight_numel, generator)
        self.w_lin2 = normal_parameter(self.lin2_plan.weight_numel, generator)
        hs = (
            [Irreps(self.irreps_in[K.EDGE_EMBEDDING]).dim]
            + fc_num_hidden_layers * [fc_hidden_size]
            + [self.uvu_plan.weight_numel]
        )
        self.radial_mlp = ScalarMLP(hs, act="silu", generator=generator)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        feats = data[K.NODE_FEATURES]
        attrs = data[K.NODE_ATTRS]
        src, dst = data[K.EDGE_INDEX]
        num_nodes = feats.shape[0]
        mask = data.get(K.NODE_MASK)

        # species one-hot FCTPs: from 16 species on the JAX module masks the
        # padded rows, below 16 it leaves them as they are; the values agree
        masked = self._onehot_attrs and attrs.shape[-1] >= 16 and mask is not None

        def apply_sc(x, w, plan):
            res = plan.apply(x, attrs, w)
            return res * mask[:, None].to(res.dtype) if masked else res

        self_connection = apply_sc(feats, self.w_sc, self.sc_plan)
        feats = apply_sc(feats, self.w_lin1, self.lin1_plan)
        edge_weights = self.radial_mlp(data[K.EDGE_EMBEDDING])

        # the edges checked and laid out on the card once per batch, by the
        # first conv layer, for them all
        if src.is_cuda and EDGE_PLAN not in data:
            data[EDGE_PLAN] = edge_plan(
                src.contiguous(), dst.contiguous(), num_nodes, num_nodes,
                with_src_order=torch.is_grad_enabled(),
            )
        edges = data.get(EDGE_PLAN)
        if edges is not None:
            src, dst = edges.src, edges.dst

        # src and dst: the plan's (contiguous) on the card, the plain
        # version's strided views on the CPU
        agg = fused_uvu_conv(
            self.uvu_plan,
            feats.contiguous(),
            data[K.EDGE_ATTRS].contiguous(),
            edge_weights.contiguous(),
            src,
            dst,
            num_nodes,
            edges,
        )
        if self.avg_num_neighbors is not None:
            agg = agg / float(np.sqrt(self.avg_num_neighbors))
        else:
            agg = agg / torch.sqrt(data[K.NUM_NEIGH].clamp_min(1.0))[:, None]

        conv_out = apply_sc(agg, self.w_lin2, self.lin2_plan)
        data[K.NODE_FEATURES] = self_connection + conv_out
        return data


class PointConvWithActivation(torch.nn.Module):
    """conv -> gate or norm activation -> (batch | instance | none)
    normalization -> node mask."""

    def __init__(
        self,
        irreps_in: Mapping,
        conv_layer_irreps: Irreps,
        generator: torch.Generator,
        fc_num_hidden_layers: int = 1,
        fc_hidden_size: int = 8,
        avg_num_neighbors: Optional[float] = None,
        activation_type: str = "gate",
        normalization: Optional[str] = None,
    ):
        super().__init__()
        if normalization not in (None, "none", "batch", "instance"):
            raise ValueError(f"unsupported normalization {normalization!r}")
        self.irreps_in = dict(irreps_in)
        info = ActivationInfo(
            Irreps(self.irreps_in[K.NODE_FEATURES]),
            Irreps(self.irreps_in[K.EDGE_ATTRS]),
            Irreps(conv_layer_irreps),
            activation_type=activation_type,
        )
        self.irreps_out = merge_irreps(self.irreps_in, {K.NODE_FEATURES: info.irreps_out})
        self.conv = PointConv(
            self.irreps_in,
            info.irreps_in,
            generator,
            fc_num_hidden_layers=fc_num_hidden_layers,
            fc_hidden_size=fc_hidden_size,
            avg_num_neighbors=avg_num_neighbors,
        )
        self.activation = info.make()
        if normalization == "batch":
            self.norm = IrrepsBatchNorm(info.irreps_out)
        elif normalization == "instance":
            self.norm = IrrepsInstanceNorm(info.irreps_out)
        else:
            self.norm = None

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = self.conv(data)
        x = self.activation(data[K.NODE_FEATURES])
        mask = data.get(K.NODE_MASK)
        if isinstance(self.norm, IrrepsInstanceNorm):
            num_graphs = data[K.CELL].reshape(-1, 3, 3).shape[0]
            x = self.norm(x, data[K.BATCH], num_graphs, mask=mask)
        elif self.norm is not None:
            x = self.norm(x, mask=mask)
        if mask is not None:
            x = x * mask[:, None].to(x.dtype)
        data[K.NODE_FEATURES] = x
        return data
