"""The work a step needs, counted from the configuration's irreps and the
Clebsch-Gordan tables' sparsity by the benchmark's own frozen code (the
reference's copy of the plans), at a batch's real nodes, edges and
crystals: no number here reads the port, its tables or its padding.

Operations are float32 operations, 2 per multiply-add; bytes are every
input read once and every output written once, float32 values and int32
indices. What the mathematics needs is counted, not what an implementation
runs: the species FCTPs as the one-hot picks one species' weights (the
same work at any species count), the uvu products through their CG
nonzeros.

Per edge and uvu path (l1 x l2 -> l3, u channels), with C its CG table:
t = C . sh once (nnz(C) multiply-adds), then per channel the contraction
of t with x (nnz(t) multiply-adds, nnz(t) the (i, k) pairs that some j
joins) and the weight and the sum into the destination (2 per output
component). The backward (dx and dw; sh takes no gradient) makes t again,
contracts it with g for dx and with x and g for dw. A dense layer's
backward is twice its forward; Adam with its L2 term takes 12 operations
per parameter.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "F32_FLOP_PER_S", "Work", "least_s"]

# one H100 SXM at its 700 W limit, NVIDIA's data sheet: HBM3 rate, and
# float32 outside the tensor cores (the port's kernels run on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
ADAM_FLOPS = 12  # per parameter: the L2 term, two moments, bias corrections, the update


def least_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time of the card for the work, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _uvu_terms(plan) -> Tuple[int, int, int]:
    """(sum over paths of nnz(C), sum of u * nnz(t), sum of u * (2 l3 + 1))."""
    from benchmark.reference.ops.clebsch_gordan import wigner_3j

    c_terms = t_terms = out_terms = 0
    for ins in plan.instructions:
        u, ir1 = plan.irreps_in1[ins.i_in1]
        ir2 = plan.irreps_in2[ins.i_in2].ir
        ir3 = plan.irreps_out[ins.i_out].ir
        nz = np.abs(wigner_3j(ir1.l, ir2.l, ir3.l)) > 1e-12
        c_terms += int(nz.sum())
        t_terms += u * int(nz.any(axis=1).sum())
        out_terms += u * ir3.dim
    return c_terms, t_terms, out_terms


def _onehot_fctp(plan) -> int:
    """Operations per node of a species FCTP as the one-hot selects one
    species' weights: a linear map per path."""
    return sum(2 * plan.irreps_in1[ins.i_in1].mul * plan.irreps_out[ins.i_out].mul
               * plan.irreps_out[ins.i_out].ir.dim for ins in plan.instructions)


def _linear(plan) -> int:
    """Operations per row of an equivariant linear (`LinearPlan`)."""
    return sum(2 * plan.irreps_in[i].mul * plan.irreps_out[j].mul * plan.irreps_in[i].ir.dim
               for i, j in plan.connections)


class Work:
    """The work counts of one configuration's model: `model` is the
    reference's copy built at the run's species and neighbour count."""

    def __init__(self, model, config: dict):
        from benchmark.reference.nn.conv import PointConv, PointConvWithActivation

        m = config["model"]
        self.params = sum(p.numel() for p in model.parameters())
        lmax = max(int(t.strip()[0]) for t in m["irreps_edge_sh"].split("+"))
        # edge vector and length, the radial basis with its cutoff, the SH
        self.edge_ops = 10 + 8 * int(m["num_radial_basis"]) + 6 * (lmax + 1) ** 2
        self.node_ops = 2 * int(m.get("species_embedding_dim", 16))  # the embedding of the one-hot
        self.layers: List[Dict[str, int]] = []  # the uvu convolutions
        for layer in model.backbone.layers:
            conv = layer.conv if isinstance(layer, PointConvWithActivation) else layer
            if not isinstance(conv, PointConv):
                continue
            c, t, o = _uvu_terms(conv.uvu_plan)
            hs = conv.radial_mlp.hs
            node = sum(_onehot_fctp(p) for p in (conv.sc_plan, conv.lin1_plan, conv.lin2_plan))
            node += 2 * conv.uvu_plan.irreps_out.dim  # the neighbour normalisation, the residual sum
            if isinstance(layer, PointConvWithActivation):
                gate_in = conv.conv_layer_irreps.dim
                node += 2 * gate_in + 6 * _features_dim(layer.irreps_out)  # gate, then norm and mask
            self.layers.append(dict(
                d1=conv.uvu_plan.irreps_in1.dim, d2=conv.uvu_plan.irreps_in2.dim,
                dw=conv.uvu_plan.weight_numel, dout=conv.uvu_plan.irreps_out.dim,
                fwd_edge=2 * c + 2 * t + 2 * o, bwd_edge=2 * c + 4 * t + 4 * o,
                mlp_edge=sum(2 * a * b for a, b in zip(hs[:-1], hs[1:])) + sum(hs[1:-1]),
                node=node))
        head = [layer for layer in model.backbone.layers if hasattr(layer, "plan")]
        self.node_ops += sum(_linear(h.plan) for h in head)
        self.graph_ops = _linear(model.plan) if hasattr(model, "plan") else 0
        self.out_dim = head[-1].plan.irreps_out.dim if head else 0

    def conv(self, kind: str, nodes: int, edges: int) -> List[Tuple[float, float]]:
        """(bytes, operations) per conv layer of K1's function ("fwd":
        x, sh, w, src, dst -> out) or of its gradient ("bwd": g, x, sh, w,
        src, dst -> dx, dw) at a batch's real nodes and edges."""
        out = []
        for L in self.layers:
            idx = 8 * edges
            if kind == "fwd":
                nbytes = 4 * (nodes * L["d1"] + nodes * L["dout"] + edges * (L["d2"] + L["dw"])) + idx
                flops = edges * L["fwd_edge"]
            else:
                nbytes = 4 * (nodes * L["dout"] + 2 * nodes * L["d1"] + edges * (L["d2"] + 2 * L["dw"])) + idx
                flops = edges * L["bwd_edge"]
            out.append((float(nbytes), float(flops)))
        return out

    def forward_flops(self, nodes: int, edges: int, graphs: int) -> Tuple[float, float]:
        """(all operations of a forward, those of its uvu convolutions)."""
        uvu = sum(edges * L["fwd_edge"] for L in self.layers)
        dense = (edges * (self.edge_ops + sum(L["mlp_edge"] for L in self.layers))
                 + nodes * (self.node_ops + sum(L["node"] for L in self.layers) + self.out_dim)
                 + graphs * (self.graph_ops + 3 * self.out_dim))
        return float(uvu + dense), float(uvu)

    def train_flops(self, nodes: int, edges: int, graphs: int) -> float:
        """A train step: the forward, its backward, Adam."""
        total, uvu = self.forward_flops(nodes, edges, graphs)
        bwd_uvu = sum(edges * L["bwd_edge"] for L in self.layers)
        return total + bwd_uvu + 2 * (total - uvu) + ADAM_FLOPS * self.params

    def eval_flops(self, nodes: int, edges: int, graphs: int) -> float:
        return self.forward_flops(nodes, edges, graphs)[0]


def _features_dim(irreps_by_field) -> int:
    """The node features' dimension of a module's output irreps."""
    from benchmark.reference.data import keys as K

    return irreps_by_field[K.NODE_FEATURES].dim
