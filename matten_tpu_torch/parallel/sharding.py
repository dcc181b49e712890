"""The ('data', 'graph') mesh of ranks, and each rank's block of a batch.

Counterpart of `matten_tpu/parallel/sharding.py`. The JAX package lays a
stacked batch over a device mesh and runs one program under `shard_map`;
here each process is one rank of the mesh, holds its own block of the
stacked batch and meets the others in the collectives of
`parallel/collectives.py`:

  * data axis: the loader's [S, ...] stack of independently padded
    sub-batches; rank (s, g) takes sub-batch s, and only the loss sums,
    gradients, batch-norm statistics and metric sums cross the axis;
  * graph axis: each sub-batch's edges (mode "edge", nodes replicated) or
    nodes and edges (modes "node" and "node_ring") split Sg ways, [S, Sg,
    ...]; rank (s, g) takes block [s, g] of those fields.

Ranks are laid out data-outermost, rank = s * n_graph + g, as the JAX mesh
reshapes its devices. Besides the axes' groups, a mesh of several ranks
holds a gloo group over the world with a long timeout of its own, for
waits on one rank's host work (`Mesh.barrier`). The mesh also names the
graph shard mode, which decides the layout of a rank's block and must be
the model's `graph_parallel_mode` (`Trainer` checks it). A model with
`graph_parallel_axis` finds the mesh in the batch it is given
(`shard_batch` puts it there under `MESH`) and raises on a batch without
one, where the JAX module fails on an unbound axis name.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.kernels.fused_conv import check_edges
from matten_tpu_torch.parallel.distributed import HOST_WAIT_S

__all__ = [
    "Axis",
    "Mesh",
    "MESH",
    "make_mesh",
    "bound_axis",
    "graph_sharded_fields",
    "node_sharded_target_keys",
    "local_block",
    "check_block_edges",
    "shard_batch",
]

# the batch dict's entry that carries the mesh to the model's collectives
MESH = "mesh"

EDGE_FIELDS = (K.EDGE_INDEX, K.EDGE_CELL_SHIFT, K.EDGE_VECTORS, K.EDGE_MASK)
NODE_FIELDS = (
    K.POSITIONS,
    K.ATOMIC_NUMBERS,
    K.SPECIES_INDEX,
    K.NUM_NEIGH,
    K.BATCH,
    K.NODE_MASK,
    K.ATOM_FEATS,
)
NODE_MODES = ("node", "node_ring")
GRAPH_MODES = ("edge",) + NODE_MODES


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it, the global ranks along it (index order) and their process group
    (None for an axis of size 1, whose collectives are the identity)."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Any = None


@dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_data, n_graph) mesh, and how a graph is
    split over the graph axis: `mode` "edge", "node" or "node_ring";
    `host`, the world's gloo group for `barrier` (None for one rank)."""

    n_data: int
    n_graph: int
    rank: int
    data: Axis
    graph: Axis
    mode: str = "edge"
    host: Any = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_graph

    def barrier(self) -> None:
        """Wait for every rank, however long the slowest one's host work
        takes (up to `HOST_WAIT_S`): the primary rank's data setup or
        checkpoint write, which the collectives' `TIMEOUT_S` must not
        bound. A gloo barrier, so no device stream is involved."""
        if self.host is not None:
            dist.barrier(group=self.host)

    def axis(self, name: str) -> Axis:
        if name not in ("data", "graph"):
            raise ValueError(f"unknown mesh axis {name!r}: the mesh has 'data' and 'graph'")
        return getattr(self, name)


def make_mesh(n_data: Optional[int] = None, n_graph: int = 1, mode: str = "edge") -> Mesh:
    """The mesh over every rank of the default group (or one process),
    splitting graphs over its graph axis in `mode`.

    Every rank calls it, in the same order as its other collectives: it
    creates the process group of each data column and graph row, and the
    world's host group, with `torch.distributed.new_group`. The world size
    must be n_data * n_graph (n_data defaults to world // n_graph)."""
    if mode not in GRAPH_MODES:
        raise ValueError(f"graph shard mode {mode!r} not in {GRAPH_MODES}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_graph
    if n_data < 1 or n_graph < 1 or n_data * n_graph != world:
        raise ValueError(
            f"a {n_data} x {n_graph} (data x graph) mesh needs {n_data * n_graph} ranks; "
            f"the world has {world}"
        )
    s, g = divmod(rank, n_graph)

    def groups(lines):
        # every rank creates every group, in one order; keeps its own
        mine = None
        for ranks in lines:
            grp = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                mine = (tuple(ranks), grp)
        return mine

    graph_ranks, graph_group = groups(
        [range(si * n_graph, (si + 1) * n_graph) for si in range(n_data)])
    data_ranks, data_group = groups(
        [range(gi, n_data * n_graph, n_graph) for gi in range(n_graph)])
    host = (dist.new_group(list(range(world)), timeout=datetime.timedelta(seconds=HOST_WAIT_S), backend="gloo")
            if world > 1 else None)
    return Mesh(
        n_data, n_graph, rank,
        Axis("data", n_data, s, data_ranks, data_group),
        Axis("graph", n_graph, g, graph_ranks, graph_group),
        mode, host,
    )


def bound_axis(data: Mapping[str, Any], name: str) -> Axis:
    """The mesh axis `name` of the batch's mesh; raises on a batch without
    one (a graph-parallel model called outside `shard_batch`)."""
    mesh = data.get(MESH)
    if mesh is None:
        raise ValueError(
            f"unbound axis name {name!r}: this model is graph-parallel (graph_parallel_axis="
            f"{name!r}) and runs only on a rank's block of a sharded batch "
            "(parallel.shard_batch, or Trainer(mesh=...)) inside a process group"
        )
    return mesh.axis(name)


def graph_sharded_fields(mode: str) -> Tuple[str, ...]:
    """The batch fields split along the graph axis: the edges in every
    mode, and the nodes too in the node modes."""
    if mode not in GRAPH_MODES:
        raise ValueError(f"graph shard mode {mode!r} not in {GRAPH_MODES}")
    return EDGE_FIELDS + NODE_FIELDS if mode in NODE_MODES else EDGE_FIELDS


def node_sharded_target_keys(mode: str, per_atom_targets: Iterable[str]) -> Tuple[str, ...]:
    """The target fields split along the graph axis: the per-atom targets
    and their selector in the node modes."""
    keys = tuple(per_atom_targets)
    if mode not in NODE_MODES or not keys:
        return ()
    return keys + ("atom_selector",)


Batch = Tuple[Dict[str, Any], Dict[str, Any]]


def local_block(mesh: Mesh, batch: Batch, per_atom_targets: Iterable[str] = ()) -> Batch:
    """This rank's block of a stacked batch (numpy or tensors): [s] of
    every field, [s, g] of the ones the mesh's mode shards over the graph
    axis. A one-rank mesh takes the batch as it is."""
    if mesh.size == 1:
        return batch
    data, targets = batch
    s, g = mesh.data.index, mesh.graph.index
    graph = mesh.n_graph > 1
    dkeys = set(graph_sharded_fields(mesh.mode)) if graph else set()
    tkeys = set(node_sharded_target_keys(mesh.mode, per_atom_targets)) if graph else set()
    return (
        {k: (v[s, g] if k in dkeys else v[s]) for k, v in data.items()},
        {k: (v[s, g] if k in tkeys else v[s]) for k, v in targets.items()},
    )


def check_block_edges(mesh: Optional[Mesh], data: Mapping[str, Any]) -> None:
    """`edge_plan`'s index check (`fused_conv.check_edges`) on a rank's
    numpy block, or on a whole batch without a mesh, with the bounds of the
    edge plans its mode builds (`nn/conv.py`), so that a bad block raises
    on the host before its copy instead of in a captured step:

      * no mesh, data parallelism and "edge" (nodes replicated): src and
        dst in [0, N), N the block's nodes;
      * "node": src into the Sg * c gathered rows, dst in [0, c), c the
        block's nodes;
      * "node_ring": for each ring group g (the g-th of Sg equal runs of
        the block's edges), src - g * c and dst in [0, c).

    dst non-decreasing in each; raises edge_plan's ValueError."""
    src, dst = data[K.EDGE_INDEX]
    c = data[K.NODE_MASK].shape[0]
    mode, sg = ("edge", 1) if mesh is None else (mesh.mode, mesh.n_graph)
    if mode == "node_ring":
        cap = src.shape[0] // sg
        for g in range(sg):
            rows = slice(g * cap, (g + 1) * cap)
            check_edges(src[rows] - g * c, dst[rows], c, c)
    else:
        check_edges(src, dst, sg * c if mode == "node" else c, c)


def shard_batch(
    mesh: Mesh,
    data: Dict[str, Any],
    targets: Dict[str, Any],
    device: Union[str, torch.device],
    per_atom_targets: Iterable[str] = (),
) -> Batch:
    """This rank's block of a stacked numpy batch, as contiguous tensors on
    `device`, with the mesh under `MESH` for the model's collectives."""
    d, t = local_block(mesh, (data, targets), per_atom_targets)
    put = lambda v: torch.as_tensor(np.ascontiguousarray(v)).to(device)
    d = {k: put(v) for k, v in d.items()}
    d[MESH] = mesh
    return d, {k: put(v) for k, v in t.items()}
