"""TFN point convolution — the message-passing core.

Counterpart of `matten_tpu/nn/conv.py`: self-connection and node-wise
mixing are species-conditioned fully-connected tensor products; the
per-edge message is a radial-MLP-weighted uvu CG tensor product of the
source features with the edge spherical harmonics, summed into the
destination nodes by the fused conv (K1) and normalized by
sqrt(avg num neighbors). Padding edges carry zero SH and zero radial
weights, so they deposit nothing.

With `graph_axis` the conv is one rank's part of a graph split over the
mesh's graph axis (`parallel/`), in one of three modes:

  * "edge": the nodes are replicated and this rank holds a contiguous
    slice of the dst-sorted edges; K1 sums its slice's messages into every
    node (n_in = n_out = N), and the partial convolutions are summed over
    the axis after the linear `lin2`;
  * "node": this rank holds c nodes and the edges into them (src global,
    dst local); the post-`lin1` features of every rank are all-gathered as
    the halo and K1 runs with n_in = Sg * c, n_out = c;
  * "node_ring": as "node", with the edges grouped by the rank that owns
    their source; Sg ring steps each sum the group whose sources sit in the
    chunk of features this rank holds (src - g * c, n_in = n_out = c) while
    the chunk is passed one rank on.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.kernels.fused_conv import edge_plan, fused_uvu_conv, item_edges_for
from matten_tpu_torch.nn.common import check_required, merge_irreps, normal_parameter
from matten_tpu_torch.nn.gate import ActivationInfo
from matten_tpu_torch.nn.norm import IrrepsBatchNorm, IrrepsInstanceNorm
from matten_tpu_torch.nn.radial import ScalarMLP
from matten_tpu_torch.ops.tensor_product import (
    TensorProductPlan,
    fully_connected_tp_plan,
    uvu_tp_plan,
)
from matten_tpu_torch.parallel.collectives import all_gather, psum, ring_shift
from matten_tpu_torch.parallel.sharding import GRAPH_MODES, NODE_MODES, bound_axis
from matten_tpu_torch.utils import timing


# the conv kernels' edge plan (`kernels.fused_conv.EdgePlan`: the checked
# edges, the dst CSR, K1's items at the item sizes of every layer's tier
# and, when gradients are recorded, the src order of the backward) in the
# batch dict: built on the card by the first PointConv of a forward (its
# index check the forward's one host read, none under a CUDA graph
# capture), and read by the others, which share the
# edges; under "node_ring" a tuple of one (src - g * c, dst, plan or None)
# per ring group g
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


def _ring_groups(data: Dict, sg: int, c: int, peer_plans):
    """The ring layout's edge groups, one per source chunk g: (src - g * c,
    dst, edge plan on the card or None), each group's indices contiguous;
    built by the first conv of a forward, with K1's items for the tiers of
    `peer_plans`, and shared by the others."""
    if EDGE_PLAN in data:
        return data[EDGE_PLAN]
    src, dst = data[K.EDGE_INDEX]
    cap2 = src.shape[0] // sg
    groups = []
    for g in range(sg):
        s = (src[g * cap2:(g + 1) * cap2] - g * c).contiguous()
        d = dst[g * cap2:(g + 1) * cap2].contiguous()
        plan = edge_plan(s, d, c, c, with_src_order=torch.is_grad_enabled(),
                         item_edges=item_edges_for(peer_plans, s.device)) if s.is_cuda else None
        groups.append((s, d, plan))
    data[EDGE_PLAN] = tuple(groups)
    return data[EDGE_PLAN]


class PointConv(torch.nn.Module):
    """TFN point convolution, on one device or as one rank's part of a
    graph split over `graph_axis` in `graph_shard_mode` (module docstring)."""

    REQUIRED = (K.NODE_FEATURES, K.NODE_ATTRS, K.EDGE_ATTRS, K.EDGE_EMBEDDING)

    def __init__(
        self,
        irreps_in: Mapping,
        conv_layer_irreps: Irreps,
        generator: torch.Generator,
        fc_num_hidden_layers: int = 1,
        fc_hidden_size: int = 8,
        avg_num_neighbors: Optional[float] = None,
        graph_axis: Optional[str] = None,
        graph_shard_mode: str = "edge",
    ):
        super().__init__()
        check_required(irreps_in, self.REQUIRED, type(self).__name__)
        if graph_shard_mode not in GRAPH_MODES:
            raise ValueError(f"graph_shard_mode {graph_shard_mode!r} not in {GRAPH_MODES}")
        self.graph_axis = graph_axis
        self.graph_shard_mode = graph_shard_mode
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
        # the uvu plans of every conv layer that shares this layer's edge
        # plan (the backbone sets its layers'): whichever layer builds it
        # lays out K1's items for all their tiers
        self.peer_plans: Tuple[TensorProductPlan, ...] = (self.uvu_plan,)
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

    def species_fctp(self, data: Dict[str, torch.Tensor]):
        """The form of this layer's species FCTPs (sc, lin1, lin2) for a
        batch, as `apply(x, w, plan)`, chosen as the JAX module chooses it:
        with every FCTP one-hot compatible, `K.SPECIES_INDEX` in the batch
        and S >= `MATTEN_ONEHOT_GATHER_MIN_S` (default 100000), the gather
        (`apply_onehot2` on the index clipped to [0, S-1], padded rows
        zeroed by the node mask); else from 16 species on the plain
        contraction against the one-hot times the node mask; else the plain
        contraction (the JAX module's scalar-matmul form below 16 species
        gives the same values). The variable is read on the host at every
        call, as the JAX module reads it when it traces: a step captured as
        a CUDA graph keeps the form it was captured with."""
        attrs = data[K.NODE_ATTRS]
        mask = data.get(K.NODE_MASK)
        s = attrs.shape[-1]
        if (self._onehot_attrs and K.SPECIES_INDEX in data
                and s >= int(os.environ.get("MATTEN_ONEHOT_GATHER_MIN_S", "100000"))):
            idx = data[K.SPECIES_INDEX].long().clamp(0, s - 1)
            return lambda x, w, plan: plan.apply_onehot2(x, idx, w, mask=mask)
        masked = self._onehot_attrs and s >= 16 and mask is not None

        def apply(x, w, plan):
            res = plan.apply(x, attrs, w)
            return res * mask[:, None].to(res.dtype) if masked else res

        return apply

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        feats = data[K.NODE_FEATURES]
        src, dst = data[K.EDGE_INDEX]
        num_nodes = feats.shape[0]
        apply_sc = self.species_fctp(data)

        # the device's time by layer while a step's marks are recorded
        # (`utils.timing`): the species FCTPs, the radial MLP, the conv
        # (edge plan, K1 and its sums); each output's backward twin
        timing.mark("fctp")
        self_connection = timing.grad_mark(apply_sc(feats, self.w_sc, self.sc_plan), "fctp")
        feats = timing.grad_mark(apply_sc(feats, self.w_lin1, self.lin1_plan), "fctp")
        timing.mark("radial")
        edge_weights = timing.grad_mark(self.radial_mlp(data[K.EDGE_EMBEDDING]).contiguous(), "radial")
        timing.mark("conv")
        sh = data[K.EDGE_ATTRS].contiguous()
        mode = None if self.graph_axis is None else self.graph_shard_mode
        axis = None if mode is None else bound_axis(data, self.graph_axis)

        if mode == "node_ring":
            # step k sums the group of the chunk this rank holds after k
            # shifts, rank (me - k)'s, and passes the chunk on
            sg, cap2 = axis.size, sh.shape[0] // axis.size
            chunk, agg = feats.contiguous(), None
            for k in range(sg):
                g = (axis.index - k) % sg
                g_src, g_dst, plan = _ring_groups(data, sg, num_nodes, self.peer_plans)[g]
                rows = slice(g * cap2, (g + 1) * cap2)
                part = fused_uvu_conv(self.uvu_plan, chunk, sh[rows], edge_weights[rows], g_src, g_dst,
                                      num_nodes, plan)
                agg = part if agg is None else agg + part
                if k < sg - 1:
                    chunk = ring_shift(chunk, axis)
        else:
            # "node": src indexes every rank's features, gathered
            x = all_gather(feats, axis) if mode == "node" else feats
            # the edges checked and laid out on the card once per batch, by
            # the first conv layer, for them all
            if src.is_cuda and EDGE_PLAN not in data:
                data[EDGE_PLAN] = edge_plan(
                    src.contiguous(), dst.contiguous(), x.shape[0], num_nodes,
                    with_src_order=torch.is_grad_enabled(),
                    item_edges=item_edges_for(self.peer_plans, src.device),
                )
            edges = data.get(EDGE_PLAN)
            if edges is not None:
                src, dst = edges.src, edges.dst
            # src and dst: the plan's (contiguous) on the card, the plain
            # version's strided views on the CPU
            agg = fused_uvu_conv(self.uvu_plan, x.contiguous(), sh, edge_weights, src, dst, num_nodes, edges)
        if self.avg_num_neighbors is not None:
            agg = agg / float(np.sqrt(self.avg_num_neighbors))
        else:
            agg = agg / torch.sqrt(data[K.NUM_NEIGH].clamp_min(1.0))[:, None]
        agg = timing.grad_mark(agg, "conv")

        timing.mark("fctp")
        conv_out = timing.grad_mark(apply_sc(agg, self.w_lin2, self.lin2_plan), "fctp")
        if mode == "edge":
            # each rank's partial convolution, linear in agg through lin2
            conv_out = psum(conv_out, axis)
        data[K.NODE_FEATURES] = self_connection + conv_out
        return data


class PointConvWithActivation(torch.nn.Module):
    """conv -> gate or norm activation -> (batch | instance | none)
    normalization -> node mask. `activation_scalars` / `activation_gates`
    ({parity "e"/"o": activation name}, or its items) pick the gate's
    activations, as in the JAX module. Under the node modes the batch norm's
    statistics are summed over `graph_axis`; the instance norm's stay
    per rank, as in the JAX module."""

    def __init__(
        self,
        irreps_in: Mapping,
        conv_layer_irreps: Irreps,
        generator: torch.Generator,
        fc_num_hidden_layers: int = 1,
        fc_hidden_size: int = 8,
        avg_num_neighbors: Optional[float] = None,
        activation_type: str = "gate",
        activation_scalars: Optional[Union[Mapping[str, str], Tuple[Tuple[str, str], ...]]] = None,
        activation_gates: Optional[Union[Mapping[str, str], Tuple[Tuple[str, str], ...]]] = None,
        normalization: Optional[str] = None,
        graph_axis: Optional[str] = None,
        graph_shard_mode: str = "edge",
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
            activation_scalars=dict(activation_scalars) if activation_scalars else None,
            activation_gates=dict(activation_gates) if activation_gates else None,
        )
        self.irreps_out = merge_irreps(self.irreps_in, {K.NODE_FEATURES: info.irreps_out})
        self.conv = PointConv(
            self.irreps_in,
            info.irreps_in,
            generator,
            fc_num_hidden_layers=fc_num_hidden_layers,
            fc_hidden_size=fc_hidden_size,
            avg_num_neighbors=avg_num_neighbors,
            graph_axis=graph_axis,
            graph_shard_mode=graph_shard_mode,
        )
        self.activation = info.make()
        if normalization == "batch":
            # node-sharded: the statistics of all the graph's nodes; the
            # instance norm takes no axis, as in the JAX module
            node_sharded = graph_axis is not None and graph_shard_mode in NODE_MODES
            self.norm = IrrepsBatchNorm(info.irreps_out, axis=graph_axis if node_sharded else None)
        elif normalization == "instance":
            self.norm = IrrepsInstanceNorm(info.irreps_out)
        else:
            self.norm = None

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = self.conv(data)
        timing.mark("gate")
        x = timing.grad_mark(self.activation(data[K.NODE_FEATURES]), "gate")
        timing.mark("norm")
        mask = data.get(K.NODE_MASK)
        if isinstance(self.norm, IrrepsInstanceNorm):
            num_graphs = data[K.CELL].reshape(-1, 3, 3).shape[0]
            x = self.norm(x, data[K.BATCH], num_graphs, mask=mask)
        elif self.norm is not None:
            x = self.norm(x, mask=mask, data=data)
        if mask is not None:
            x = x * mask[:, None].to(x.dtype)
        data[K.NODE_FEATURES] = timing.grad_mark(x, "norm")
        return data
