"""Crystal graphs and padded static-shape batching.

Replaces the reference's PyG DataPoint/Crystal/Batch machinery (reference C3
+ N10, data/data.py:17-262): graphs are plain numpy records on the host;
batching concatenates them and pads nodes/edges/graphs to static bucket
shapes so XLA compiles once per bucket. Dummy edges connect a padded node to
itself; dummy nodes/graphs are excluded from statistics and losses via
boolean masks (SURVEY.md §7 hard part 3).

Edges are sorted by destination node after batching so segment reductions
are segment-local (the layout the Pallas aggregation kernel assumes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.data import keys as K
from benchmark.reference.data.neighborlist import periodic_radius_graph
from benchmark.reference.data.structure import Structure

__all__ = [
    "CrystalGraph",
    "PadSpec",
    "collate_graphs",
    "pad_spec_for",
    "chunk_align_edges",
]

# x-dict keys that are always per-graph, never per-node (collation must not
# shape-sniff these: a batch of 1-atom graphs makes [1, F] rows look node-like)
PER_GRAPH_KEYS = frozenset({K.GLOBAL_FEATS, "target_weight"})


@dataclass
class CrystalGraph:
    """One crystal as a graph (host-side numpy, float64 geometry)."""

    pos: np.ndarray  # [N, 3] cartesian
    edge_index: np.ndarray  # [2, E]
    edge_cell_shift: np.ndarray  # [E, 3]
    cell: np.ndarray  # [3, 3]
    num_neigh: np.ndarray  # [N]
    atomic_numbers: np.ndarray  # [N]
    x: Dict[str, np.ndarray] = field(default_factory=dict)  # extra inputs
    y: Dict[str, np.ndarray] = field(default_factory=dict)  # targets

    @property
    def num_nodes(self) -> int:
        return len(self.pos)

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    @classmethod
    def from_structure(
        cls,
        struct: Structure,
        r_cut: float,
        x: Optional[Dict[str, np.ndarray]] = None,
        y: Optional[Dict[str, np.ndarray]] = None,
    ) -> "CrystalGraph":
        """Mirror of Crystal.from_pymatgen (reference data/data.py:262-283)."""
        pos = struct.cart_coords
        edge_index, shifts, num_neigh = periodic_radius_graph(
            pos, struct.lattice, r_cut, pbc=struct.pbc
        )
        return cls(
            pos=pos,
            edge_index=edge_index,
            edge_cell_shift=shifts,
            cell=struct.lattice,
            num_neigh=num_neigh,
            atomic_numbers=struct.atomic_numbers.copy(),
            x=dict(x or {}),
            y=dict(y or {}),
        )


@dataclass(frozen=True)
class PadSpec:
    num_nodes: int
    num_edges: int
    num_graphs: int
    # node-chunk / edge-block geometry for the chunk-aligned edge layout
    # consumed by the node-chunked Pallas accumulator
    # (kernels/fused_conv.py). None = plain dst-sorted layout.
    node_chunk: Optional[int] = None
    edge_block: int = 256


def chunk_align_edges(
    edge_index: np.ndarray,
    edge_cell_shift: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes: int,
    node_chunk: int,
    edge_block: int,
    capacity: int,
    src_view: bool = True,
    num_src_nodes: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Re-layout a dst-sorted edge list for the chunked fused kernel.

    Groups edges by destination node-chunk and pads each group to a multiple
    of `edge_block` with inert self-loop fill edges (mask False -> zero SH /
    radial weights downstream), so every edge block deposits into exactly
    one [D_out, node_chunk] accumulator block. Also builds the source-sorted
    permutation view with the same per-chunk alignment (fill slots point at
    a masked edge) for the dx backward kernel.

    src_view=False skips the source-sorted view (emitted as inert
    fill-only arrays) — only safe when every consumer stays on the v2
    resident-node backward (n_src <= RESIDENT_NODES_MAX).

    `num_src_nodes` (default `num_nodes`) sizes the node space the SOURCE
    ids live in: under node-sharded graph parallelism src ids index the
    halo-gathered GLOBAL array (num_src_nodes = shards x local nodes) while
    dst ids are shard-local — the src-sorted view then groups by global
    source chunk so the v1 dx backward can scatter into a chunked
    [d1, num_src_nodes] output beyond the VMEM-resident limit.

    Returns the replacement edge arrays + the kernel owner maps.
    """
    if num_src_nodes is None:
        num_src_nodes = num_nodes
    assert num_src_nodes % node_chunk == 0, (num_src_nodes, node_chunk)
    assert num_nodes % node_chunk == 0, (num_nodes, node_chunk)
    assert capacity % edge_block == 0, (capacity, edge_block)
    nc = num_nodes // node_chunk
    src, dst = np.asarray(edge_index)
    real = np.asarray(edge_mask, dtype=bool)
    n_real = int(real.sum())

    ei = np.zeros((2, capacity), dtype=np.int32)
    shift = np.zeros((capacity, 3), dtype=edge_cell_shift.dtype)
    mask = np.zeros(capacity, dtype=bool)
    nb = capacity // edge_block
    dst_owner = np.full(nb, nc - 1, dtype=np.int32)

    def _fill(a, b, node):
        # inert self-loops at `node` (zero-length -> masked SH, zero radial)
        ei[:, a:b] = node

    off = 0
    r_src = src[real]
    r_dst = dst[real]
    r_shift = edge_cell_shift[real]
    owner_of = r_dst // node_chunk
    for c in range(nc):
        sel = owner_of == c
        k = int(sel.sum())
        end = off + k
        if end > capacity:
            raise ValueError(
                f"chunk-aligned edge capacity {capacity} exceeded "
                f"({n_real} real edges, {nc} chunks, block {edge_block})"
            )
        ei[0, off:end] = r_src[sel]
        ei[1, off:end] = r_dst[sel]
        shift[off:end] = r_shift[sel]
        mask[off:end] = True
        # every chunk owns >= 1 block, even with no incident real edges —
        # otherwise the kernel's owner map never visits that chunk's output
        # block and it stays uninitialized HBM (the _make_pad slack budgets
        # exactly one extra block per chunk)
        pad_end = off + max(1, int(np.ceil(k / edge_block))) * edge_block
        if pad_end > capacity:
            raise ValueError(
                f"chunk-aligned edge capacity {capacity} exceeded by alignment"
            )
        _fill(end, pad_end, c * node_chunk)
        dst_owner[off // edge_block : pad_end // edge_block] = c
        off = pad_end
    _fill(off, capacity, num_nodes - 1)  # trailing blocks -> last chunk

    # source-sorted permutation view (for the dx scatter): same grouping by
    # SOURCE chunk; fill slots point at any masked (inert) edge
    dummies = np.flatnonzero(~mask)
    assert dummies.size > 0, "chunk alignment requires >= 1 dummy edge slot"
    fill_idx = int(dummies[0])
    nc_src = num_src_nodes // node_chunk
    src_perm = np.full(capacity, fill_idx, dtype=np.int32)
    src_owner = np.full(nb, nc_src - 1, dtype=np.int32)
    if not src_view:
        return {
            K.EDGE_INDEX: ei,
            K.EDGE_CELL_SHIFT: shift,
            K.EDGE_MASK: mask,
            K.EDGE_DST_CHUNK: dst_owner,
            K.EDGE_SRC_PERM: src_perm,
            K.EDGE_SRC_CHUNK: src_owner,
            K.EDGE_CHUNK_TAG: np.zeros(nc, dtype=np.int8),
        }
    real_idx = np.flatnonzero(mask)
    s_owner = ei[0, real_idx] // node_chunk
    order = np.argsort(s_owner, kind="stable")
    real_sorted = real_idx[order]
    s_owner = s_owner[order]
    off = 0
    for c in range(nc_src):
        sel = s_owner == c
        k = int(sel.sum())
        end = off + k
        if end > capacity:
            raise ValueError("src-sorted chunk alignment capacity exceeded")
        src_perm[off:end] = real_sorted[sel]
        # same >=1-block guarantee as the dst view (dx gradients)
        pad_end = off + max(1, int(np.ceil(k / edge_block))) * edge_block
        if pad_end > capacity:
            raise ValueError("src-sorted chunk alignment capacity exceeded")
        src_owner[off // edge_block : pad_end // edge_block] = c
        off = pad_end
    # fill slots (already = fill_idx) scatter zero messages into the owner
    # chunk's first node; trailing blocks keep owner nc-1

    return {
        K.EDGE_INDEX: ei,
        K.EDGE_CELL_SHIFT: shift,
        K.EDGE_MASK: mask,
        K.EDGE_DST_CHUNK: dst_owner,
        K.EDGE_SRC_PERM: src_perm,
        K.EDGE_SRC_CHUNK: src_owner,
        # static geometry rides in the shape (len == num node chunks)
        K.EDGE_CHUNK_TAG: np.zeros(nc, dtype=np.int8),
    }


def _round_bucket(n: int, multiple: int) -> int:
    return int(np.ceil((n + 1) / multiple)) * multiple


def pad_spec_for(
    graphs: Sequence[CrystalGraph],
    node_multiple: int = 64,
    edge_multiple: int = 512,
    graph_multiple: int = 8,
) -> PadSpec:
    """Bucketed pad sizes for a batch (always leaves >=1 dummy slot)."""
    n = sum(g.num_nodes for g in graphs)
    e = sum(g.num_edges for g in graphs)
    return PadSpec(
        _round_bucket(n, node_multiple),
        _round_bucket(e, edge_multiple),
        _round_bucket(len(graphs), graph_multiple),
    )


def collate_graphs(
    graphs: Sequence[CrystalGraph],
    pad: PadSpec,
    species_map: Optional[np.ndarray] = None,
    dtype=np.float32,
    per_node_keys: Optional[frozenset] = None,
    precompute_edge_vectors: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Concatenate + pad a list of graphs into a static-shape batch.

    Returns (data, targets):
      data — the model input dict (keys.py fields + masks),
      targets — per-graph fields stacked to [G_pad, ...], per-node fields to
      [N_pad, ...] (classified by leading-dimension == num_nodes).

    `per_node_keys`, when given, pins the per-node/per-graph classification
    of extra x/y fields (the BatchLoader computes it once over the WHOLE
    dataset). The per-batch shape heuristic misclassifies a batch composed
    entirely of 1-atom graphs — [1, D] graph targets then match num_nodes —
    which size-sorted batching makes likely, and a pytree-shape change
    between batches breaks stacked shard layouts.

    `species_map` is the Z -> species-index lookup from
    nn.embedding.atomic_number_map; when given, species_index is precomputed
    host-side.
    """
    ng = len(graphs)
    n_tot = sum(g.num_nodes for g in graphs)
    e_tot = sum(g.num_edges for g in graphs)
    if pad.num_nodes <= n_tot:
        raise ValueError(f"node pad {pad.num_nodes} <= total nodes {n_tot}")
    if pad.num_edges < e_tot:
        raise ValueError(f"edge pad {pad.num_edges} < total edges {e_tot}")
    if pad.num_graphs < ng:
        raise ValueError(f"graph pad {pad.num_graphs} < num graphs {ng}")

    pos = np.zeros((pad.num_nodes, 3), dtype=dtype)
    atomic_numbers = np.zeros(pad.num_nodes, dtype=np.int32)
    num_neigh = np.zeros(pad.num_nodes, dtype=dtype)
    batch = np.full(pad.num_nodes, pad.num_graphs - 1, dtype=np.int32)
    node_mask = np.zeros(pad.num_nodes, dtype=bool)

    edge_index = np.full((2, pad.num_edges), pad.num_nodes - 1, dtype=np.int32)
    edge_cell_shift = np.zeros((pad.num_edges, 3), dtype=dtype)
    edge_mask = np.zeros(pad.num_edges, dtype=bool)

    cell = np.tile(np.eye(3, dtype=dtype), (pad.num_graphs, 1, 1))
    graph_mask = np.zeros(pad.num_graphs, dtype=bool)

    node_off = 0
    edge_off = 0
    for gi, g in enumerate(graphs):
        n, e = g.num_nodes, g.num_edges
        pos[node_off : node_off + n] = g.pos
        atomic_numbers[node_off : node_off + n] = g.atomic_numbers
        num_neigh[node_off : node_off + n] = g.num_neigh
        batch[node_off : node_off + n] = gi
        node_mask[node_off : node_off + n] = True
        edge_index[:, edge_off : edge_off + e] = g.edge_index + node_off
        edge_cell_shift[edge_off : edge_off + e] = g.edge_cell_shift
        edge_mask[edge_off : edge_off + e] = True
        cell[gi] = g.cell
        graph_mask[gi] = True
        node_off += n
        edge_off += e

    # sort edges by destination for segment-local aggregation
    order = np.argsort(edge_index[1], kind="stable")
    edge_index = edge_index[:, order]
    edge_cell_shift = edge_cell_shift[order]
    edge_mask = edge_mask[order]

    chunk_fields = {}
    if pad.node_chunk is not None and pad.num_nodes > pad.node_chunk:
        chunk_fields = chunk_align_edges(
            edge_index,
            edge_cell_shift,
            edge_mask,
            pad.num_nodes,
            pad.node_chunk,
            pad.edge_block,
            pad.num_edges,
        )
        edge_index = chunk_fields.pop(K.EDGE_INDEX)
        edge_cell_shift = chunk_fields.pop(K.EDGE_CELL_SHIFT)
        edge_mask = chunk_fields.pop(K.EDGE_MASK)

    data = {
        K.POSITIONS: pos,
        K.ATOMIC_NUMBERS: atomic_numbers,
        K.NUM_NEIGH: num_neigh,
        K.BATCH: batch,
        K.NODE_MASK: node_mask,
        K.EDGE_INDEX: edge_index,
        K.EDGE_CELL_SHIFT: edge_cell_shift,
        K.EDGE_MASK: edge_mask,
        K.CELL: cell,
        K.GRAPH_MASK: graph_mask,
    }
    data.update(chunk_fields)
    if species_map is not None:
        z = np.clip(atomic_numbers, 0, len(species_map) - 1)
        data[K.SPECIES_INDEX] = species_map[z].astype(np.int32)

    # extra inputs: per-node (atom_feats) or per-graph (global_feats,
    # target_weight). Known per-graph keys are routed explicitly — a batch of
    # all 1-atom graphs would otherwise pass the shape[0]==num_nodes sniff
    # and get padded node-wise (silently wrong features downstream); the
    # heuristic only applies to unknown keys.
    for key in graphs[0].x:
        vals = [np.asarray(g.x[key]) for g in graphs]
        if key in PER_GRAPH_KEYS:
            per_node = False
        elif per_node_keys is not None:
            per_node = key in per_node_keys
        else:
            per_node = vals[0].ndim >= 1 and vals[0].shape[0] == graphs[0].num_nodes
            if per_node and not all(
                v.shape[0] == g.num_nodes for v, g in zip(vals, graphs)
            ):
                per_node = False
        if per_node:
            stacked = np.concatenate(vals, axis=0)
            out = np.zeros((pad.num_nodes,) + stacked.shape[1:], dtype=dtype)
            out[:n_tot] = stacked
        else:
            stacked = np.concatenate([v.reshape(1, -1) for v in vals], axis=0)
            out = np.zeros((pad.num_graphs,) + stacked.shape[1:], dtype=dtype)
            out[:ng] = stacked
        data[key] = out

    # targets
    targets: Dict[str, np.ndarray] = {}
    for key in graphs[0].y:
        vals = [np.asarray(g.y[key]) for g in graphs]
        if per_node_keys is not None:
            per_node = key in per_node_keys
        else:
            per_node = vals[0].ndim >= 1 and vals[0].shape[0] == graphs[0].num_nodes
            # disambiguate single-node graphs with [1, D] graph targets:
            # per-graph unless every graph's rows match its node count
            if per_node and not all(
                v.shape[0] == g.num_nodes for v, g in zip(vals, graphs)
            ):
                per_node = False
        if per_node:
            stacked = np.concatenate(vals, axis=0)
            out = np.zeros((pad.num_nodes,) + stacked.shape[1:], dtype=stacked.dtype if stacked.dtype == bool else dtype)
            out[:n_tot] = stacked
        else:
            stacked = np.concatenate([v.reshape(1, -1) for v in vals], axis=0)
            out = np.zeros((pad.num_graphs,) + stacked.shape[1:], dtype=dtype)
            out[:ng] = stacked
        targets[key] = out

    # set precompute_edge_vectors=False for models that need positional
    # gradients (force/stress heads): precomputed vectors are constants
    # w.r.t. POSITIONS (nn.edge_geometry.with_edge_vectors raises loudly
    # when require_position_gradients meets a precomputed batch)
    if precompute_edge_vectors:
        attach_edge_vectors(data)
    return data, targets


def attach_edge_vectors(data: Dict[str, np.ndarray], dst_local: bool = False) -> None:
    """Precompute per-edge displacement vectors host-side (f64 math -> f32).

    nn.edge_geometry.with_edge_vectors() early-exits on EDGE_VECTORS, so
    attaching them at collation removes the on-device per-edge cell gather
    and shift@cell contraction (~0.5 ms of scalar-unit-bound gathers per
    production step). Valid because no supported target needs positional
    gradients — the reference never trains on forces/stress either
    (its datasets carry tensors only, dataset/structure_scalar_tensor.py).

    Handles every collation layout in place: plain [2, E] and sharded
    [Sg, 2, cap] edge indices; `dst_local=True` for node-sharded layouts
    where dst ids are shard-local and src ids index the concatenated
    [Sg*c] node space. Dummy edges get vec = 0 (the bessel window kills
    zero-length edges, and SH attrs are edge-masked), preserving the
    padded-edge inertness contract (DEVNOTES).
    """
    ei = data[K.EDGE_INDEX]
    shift = np.asarray(data[K.EDGE_CELL_SHIFT], dtype=np.float64)
    pos = np.asarray(data[K.POSITIONS], dtype=np.float64).reshape(-1, 3)
    cell = np.asarray(data[K.CELL], dtype=np.float64).reshape(-1, 3, 3)
    batch = np.asarray(data[K.BATCH]).reshape(-1)
    mask = data[K.EDGE_MASK]
    if ei.ndim == 2:
        src, dst = ei[0], ei[1]
        vec = pos[dst] - pos[src] + np.einsum(
            "ei,eij->ej", shift, cell[batch[dst]]
        )
        data[K.EDGE_VECTORS] = np.where(
            mask[:, None], vec, 0.0
        ).astype(np.float32)
        return
    sg = ei.shape[0]
    c = pos.shape[0] // sg
    vecs = np.zeros(ei.shape[:1] + ei.shape[2:] + (3,), dtype=np.float64)
    for s in range(sg):
        src, dst = ei[s, 0], ei[s, 1]
        dst_g = dst + s * c if dst_local else dst
        vecs[s] = pos[dst_g] - pos[src] + np.einsum(
            "ei,eij->ej", shift[s], cell[batch[dst_g]]
        )
    data[K.EDGE_VECTORS] = np.where(mask[..., None], vecs, 0.0).astype(
        np.float32
    )
