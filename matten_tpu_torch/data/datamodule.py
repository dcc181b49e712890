"""Data module: datasets -> shuffled, padded, bucketed numpy batches.

Counterpart of `matten_tpu/data/datamodule.py` on one device: graphs are
converted once (optionally cached), batches are padded to a small ladder of
bucket shapes, and `get_to_model_info()` provides the dataset -> model
hand-off. For the same graphs and seed `BatchLoader` yields the batches the
JAX loader yields with `node_chunk=None`: the same seeded numpy shuffle, the
same bucket ladder and size sort, the same collation.

That is the port's layout. The JAX loader's default (`node_chunk="auto"`)
aligns the edges of batches above 128 padded nodes to the node chunks of
its Pallas accumulator, a TPU layout with other pad shapes; the CUDA
kernels walk dst-sorted edges and need no alignment, so `node_chunk` here
is absent, None or "auto", all meaning no chunking.

The sharded layouts are the JAX loader's too: `num_shards` S stacks S
independently padded sub-batches [S, ...] (data parallelism);
`num_edge_shards` Sg splits each sub-batch's dst-sorted edges into Sg
contiguous slices [S, Sg, ...] (graph mode "edge"), with `node_shard` its
nodes into Sg contiguous chunks of c and each edge into its dst owner's
shard, src global and dst local (mode "node"), and with `ring` each
shard's edges into Sg equal slots by their src owner (mode "node_ring").
One index rule differs from the JAX layout, and only in the node layouts'
padding slots: the JAX loader fills them with index 0, so dst drops back
to 0 after the last real edge of a shard (and, in the ring layout, src - g
* c is negative), which its gathers wrap and the CUDA kernels' edge plans
refuse (dst non-decreasing in [0, c), src in range). Here a padding slot
holds dst = c - 1 and a src in its slot owner's chunk (so * c + c - 1,
the shard's own in the node layout), with the JAX layout's edge mask
(False), cell shift (1e6) and zero edge vector, so it stays inert.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.data.dataset import DatasetStatistics, TensorDatasetConfig, load_tensor_dataset
from matten_tpu_torch.data.graph import CrystalGraph, PadSpec, attach_edge_vectors, collate_graphs
from matten_tpu_torch.nn.embedding import atomic_number_map

logger = logging.getLogger(__name__)

__all__ = ["TensorDataModule", "BatchLoader"]

Batch = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]

# a distinct part of the graph cache's hashed key: the JAX package pickles
# its own CrystalGraph under the same directory and file-name pattern
_CACHE_TAG = "matten_tpu_torch"


class BatchLoader:
    """Yields (data, targets) numpy batches with bucketed static shapes."""

    def __init__(
        self,
        graphs: List[CrystalGraph],
        batch_size: int,
        species_map: np.ndarray,
        shuffle: bool = False,
        seed: int = 0,
        node_multiple: int = 32,
        edge_multiple: int = 512,
        drop_last: bool = False,
        num_shards: int = 1,
        num_edge_shards: int = 1,
        node_shard: bool = False,
        ring: bool = False,
        node_chunk: Union[str, None] = None,
        num_buckets: int = 4,
        batch_by_size: bool = False,
        precompute_edge_vectors: bool = True,
    ):
        """num_shards > 1 yields stacked per-shard batches [S, ...] for data
        parallelism (each shard an independently padded sub-batch of the
        graphs s, s + S, ... whose edge_index refers only to its own node
        block; a shard without graphs reuses the first graph with its masks
        zeroed). num_edge_shards > 1 splits each sub-batch along the mesh's
        graph axis [S, Sg, ...]: its dst-sorted edges into contiguous
        slices, or with node_shard its nodes and their edges, with ring
        grouped by source owner (module docstring). A stacked batch shares
        one pad shape, the smallest level that fits every shard.

        num_buckets > 1 builds a small ladder of pad shapes sized from the
        batch-sum distribution (quantile levels, capped by the worst case);
        each batch is padded to the smallest level that fits.

        batch_by_size composes batches from similarly-sized graphs
        (shuffle, sort within windows of 4*batch_size, carve batches,
        shuffle the batch order); the ladder then takes one level per rank
        band of the size-sorted batches.

        precompute_edge_vectors=False leaves EDGE_VECTORS out of the batches,
        so the model computes them from POSITIONS (for models that need
        position gradients)."""
        if node_chunk not in (None, "auto"):
            raise ValueError(
                f"node_chunk={node_chunk!r} selects the JAX package's chunk-aligned "
                "TPU layout; this loader takes None or 'auto' (no chunking); the JAX "
                "loader's other layouts are its sharded ones (num_shards, num_edge_shards, "
                "node_shard, ring)"
            )
        if batch_size % num_shards != 0:
            raise ValueError(f"batch_size {batch_size} not divisible by {num_shards}")
        self.num_shards = num_shards
        self.num_edge_shards = num_edge_shards
        self.node_shard = node_shard
        self.ring = ring
        # ring slot capacity ladder: (padded edges, Sg) -> running max
        self._ring_cap2: Dict[Tuple[int, int], int] = {}
        self.graphs = graphs
        self.batch_size = batch_size
        self.species_map = species_map
        self.shuffle = shuffle
        self.node_multiple = node_multiple
        self.edge_multiple = edge_multiple
        self.drop_last = drop_last
        self.batch_by_size = batch_by_size
        if batch_by_size and len(graphs) <= 4 * batch_size:
            # one sort window: the size sort fixes batch membership every
            # epoch, and batch norm then fits per-batch statistics
            logger.warning(
                "batch_by_size with a dataset that fits one sort window "
                "(%d graphs <= 4*batch_size=%d): batch membership becomes "
                "deterministic across epochs; models with batch "
                "normalization can overfit per-batch statistics and eval "
                "quality degrades. Use batch_by_size: false for small "
                "datasets.",
                len(graphs),
                4 * batch_size,
            )
        self.precompute_edge_vectors = precompute_edge_vectors
        self.seed = seed
        self._rng = np.random.default_rng(seed)

        # pin the per-node/per-graph classification of extra fields over the
        # WHOLE dataset (a per-batch shape sniff misclassifies a batch of
        # 1-atom graphs)
        def _is_per_node(get):
            return all(
                np.asarray(get(g)).ndim >= 1 and np.asarray(get(g)).shape[0] == g.num_nodes
                for g in graphs
            )

        pk = set()
        if graphs:
            for key in graphs[0].y:
                if _is_per_node(lambda g, k=key: g.y[k]):
                    pk.add(key)
            for key in graphs[0].x:
                if _is_per_node(lambda g, k=key: g.x[k]):
                    pk.add(key)
        self._per_node_keys = frozenset(pk)

        # worst-case bucket: the k largest graphs in one (sub-)batch
        per_shard = batch_size // num_shards
        sizes = np.sort(np.array([g.num_nodes for g in graphs]))[::-1]
        esizes = np.sort(np.array([g.num_edges for g in graphs]))[::-1]
        k = min(per_shard, len(graphs))
        n_max = int(sizes[:k].sum())
        e_max = int(esizes[:k].sum())
        self.pad = self._make_pad(n_max, e_max)

        # bucket ladder: the (largest sub-)batch sums of 128 simulated epochs
        # of the same pipeline (shuffle [-> window sort] -> carve batches ->
        # strided shard split), drawn from a fixed generator so every epoch
        # sees the same ladder; the worst case is the last level
        self.pads = [self.pad]
        if num_buckets > 1 and 1 < k < len(graphs):
            arr_n = np.array([g.num_nodes for g in graphs])
            arr_e = np.array([g.num_edges for g in graphs])
            boot = np.random.default_rng(0xB0C)
            samp_n, samp_e = [], []
            rank_n, rank_e = {}, {}
            for _ in range(128):
                order = boot.permutation(len(graphs))
                if batch_by_size:
                    order = self._size_order(order, arr_e)
                for r, j in enumerate(range(0, len(order), batch_size)):
                    b = order[j : j + batch_size]
                    lists = [b[s::num_shards] for s in range(num_shards) if len(b[s::num_shards])]
                    bn = max(int(arr_n[sub].sum()) for sub in lists)
                    be = max(int(arr_e[sub].sum()) for sub in lists)
                    samp_n.append(bn)
                    samp_e.append(be)
                    rank_n[r] = max(rank_n.get(r, 0), bn)
                    rank_e[r] = max(rank_e.get(r, 0), be)
            if batch_by_size:
                # size-sorted batches keep their rank (batch 0 is the
                # heaviest of its window): a level at each rank band's
                # simulated max fits that band's batches snugly
                nranks = len(rank_n)
                nb = min(num_buckets, nranks)
                ladder = []
                for band in range(nb):
                    rs = [r for r in rank_n if r * nb // nranks == band]
                    ladder.append(
                        self._make_pad(
                            min(max(rank_n[r] for r in rs), n_max),
                            min(max(rank_e[r] for r in rs), e_max),
                        )
                    )
            else:
                # random batches: evenly spaced quantile levels
                qs = [(i + 1) / num_buckets for i in range(num_buckets)]
                ladder = [
                    self._make_pad(
                        min(int(np.quantile(samp_n, q)), n_max),
                        min(int(np.quantile(samp_e, q)), e_max),
                    )
                    for q in qs
                ]
            pads = sorted(set(ladder + [self.pad]), key=lambda p: (p.num_nodes, p.num_edges))
            # keep only strictly growing shapes (dedup after rounding)
            self.pads = []
            for p in pads:
                if not self.pads or (
                    p.num_nodes > self.pads[-1].num_nodes or p.num_edges > self.pads[-1].num_edges
                ):
                    self.pads.append(p)

    def _make_pad(self, n: int, e: int) -> PadSpec:
        """Pad spec for raw totals (n nodes, e edges) of a (sub-)batch: at
        least one padding node, both rounded up to their multiples, a graph
        slot per graph of a shard."""
        return PadSpec(
            self._round(n + 1, self.node_multiple),
            self._round(max(e, 1), self.edge_multiple),
            self.batch_size // self.num_shards,
        )

    def _size_order(self, idx: np.ndarray, sizes: np.ndarray) -> np.ndarray:
        """Window-sorted ordering for batch_by_size (stable within windows
        of 4*batch_size, so shuffling still mixes window membership).
        Descending, so the ragged tail batch gets the window's smallest
        graphs instead of its largest."""
        w = 4 * self.batch_size
        parts = [
            idx[j : j + w][np.argsort(-sizes[idx[j : j + w]], kind="stable")]
            for j in range(0, len(idx), w)
        ]
        return np.concatenate(parts) if parts else idx

    def _pick_pad(self, shard_lists: List[List[CrystalGraph]]) -> PadSpec:
        """The smallest ladder level that fits every shard of the batch."""
        n = max(sum(g.num_nodes for g in gs) for gs in shard_lists)
        e = max(sum(g.num_edges for g in gs) for gs in shard_lists)
        for p in self.pads:
            if p.num_nodes > n and p.num_edges >= e:
                return p
        return self.pads[-1]

    @staticmethod
    def _round(n: int, m: int) -> int:
        return int(np.ceil(n / m)) * m

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling deterministically per epoch, so a resumed run
        replays the batch order the uninterrupted run would have drawn."""
        self._rng = np.random.default_rng(self.seed * 100_003 + epoch)

    def __len__(self) -> int:
        n = len(self.graphs)
        return n // self.batch_size if self.drop_last else int(np.ceil(n / self.batch_size))

    NODE_FIELDS = (K.POSITIONS, K.ATOMIC_NUMBERS, K.SPECIES_INDEX, K.NUM_NEIGH, K.BATCH, K.NODE_MASK)

    def _ring_order(self, graphs: List[CrystalGraph]) -> List[CrystalGraph]:
        """Size-balanced graph order for the ring layout: largest first,
        each graph to the least loaded of the Sg node shards (by node
        count), emitted in shard order, so graphs mostly stay inside one
        node chunk and their edges in the diagonal ring slots."""
        sg = self.num_edge_shards
        if len(graphs) <= 1 or sg <= 1:
            return graphs
        order = sorted(range(len(graphs)), key=lambda i: -graphs[i].num_nodes)
        bins: List[List[CrystalGraph]] = [[] for _ in range(sg)]
        loads = np.zeros(sg, dtype=np.int64)
        for i in order:
            b = int(np.argmin(loads))
            bins[b].append(graphs[i])
            loads[b] += graphs[i].num_nodes
        return [g for b in bins for g in b]

    def _shard_nodes_and_edges(self, data: Dict, targets: Dict) -> Batch:
        """Node-sharded layout [Sg, ...]: nodes in Sg contiguous chunks of c,
        each edge with the shard that owns its destination (src global, dst
        local), padding slots inert at dst = c - 1 (module docstring); with
        `ring`, each shard's edges in Sg slots of one capacity by their
        source owner (group-major). The slot capacity is the most edges of
        any (dst owner, src owner) pair, rounded up to max(64,
        edge_multiple / Sg) and never lowered for a padded edge count, so
        the shapes settle after the first epoch."""
        sg = self.num_edge_shards
        n = data[K.POSITIONS].shape[0]
        if n % sg:
            raise ValueError(f"padded nodes {n} not divisible by {sg} node shards")
        c = n // sg
        data = dict(data)
        data.pop(K.EDGE_VECTORS, None)  # the unsharded layout's
        src, dst = data[K.EDGE_INDEX]
        real = data[K.EDGE_MASK]
        owner = dst // c
        if self.ring:
            src_owner = src // c
            e_pad = data[K.EDGE_INDEX].shape[1]
            cnt = np.zeros((sg, sg), dtype=np.int64)
            np.add.at(cnt, (owner[real], src_owner[real]), 1)
            q = max(64, self.edge_multiple // sg)
            need = int(np.ceil(max(int(cnt.max()), 1) / q)) * q
            cap2 = max(need, self._ring_cap2.get((e_pad, sg), 0))
            self._ring_cap2[(e_pad, sg)] = cap2
            slots = [(so, so * cap2, cap2) for so in range(sg)]
        else:
            slots = [(None, 0, 2 * (data[K.EDGE_INDEX].shape[1] // sg))]
        cap = sum(size for _, _, size in slots)
        ei = np.empty((sg, 2, cap), dtype=np.int32)
        shift = np.full((sg, cap, 3), 1e6, dtype=data[K.EDGE_CELL_SHIFT].dtype)
        mask = np.zeros((sg, cap), dtype=bool)
        for s in range(sg):
            for so, o, size in slots:
                # padding: dst = c - 1, src in the slot owner's chunk
                ei[s, 0, o:o + size] = (s if so is None else so) * c + c - 1
                ei[s, 1, o:o + size] = c - 1
                sel = real & (owner == s)
                if so is not None:
                    sel &= src_owner == so
                k = int(sel.sum())
                if k > size:
                    raise ValueError(f"edge shard ({s}, {so}) overflows its {size} slots with {k} edges")
                ei[s, 0, o:o + k] = src[sel]
                ei[s, 1, o:o + k] = dst[sel] - s * c
                shift[s, o:o + k] = data[K.EDGE_CELL_SHIFT][sel]
                mask[s, o:o + k] = True
        data[K.EDGE_INDEX] = ei
        data[K.EDGE_CELL_SHIFT] = shift
        data[K.EDGE_MASK] = mask
        # per-node feature columns too: the JAX layout leaves them whole,
        # and its sharded step then fails on a model that reads them
        for key in self.NODE_FIELDS + tuple(sorted(self._per_node_keys & set(data))):
            if key in data:
                data[key] = data[key].reshape((sg, c) + data[key].shape[1:])
        # per-node targets shard with their nodes
        targets = {key: v.reshape((sg, c) + v.shape[1:]) if v.shape[0] == n else v
                   for key, v in targets.items()}
        return data, targets

    def _shard_edges(self, data: Dict) -> Dict:
        """Edge-sharded layout: the dst-sorted edges in Sg contiguous slices
        [Sg, ...], nodes replicated."""
        sg = self.num_edge_shards
        e = data[K.EDGE_INDEX].shape[1]
        if e % sg:
            raise ValueError(f"padded edges {e} not divisible by {sg} edge shards")
        data = dict(data)
        data.pop(K.EDGE_VECTORS, None)  # the unsharded layout's
        data[K.EDGE_INDEX] = np.ascontiguousarray(
            np.transpose(data[K.EDGE_INDEX].reshape(2, sg, e // sg), (1, 0, 2)))
        data[K.EDGE_CELL_SHIFT] = data[K.EDGE_CELL_SHIFT].reshape(sg, e // sg, 3)
        data[K.EDGE_MASK] = data[K.EDGE_MASK].reshape(sg, e // sg)
        return data

    def _collate(self, graphs: List[CrystalGraph], pad: PadSpec) -> Batch:
        return collate_graphs(
            graphs,
            pad,
            species_map=self.species_map,
            per_node_keys=self._per_node_keys,
            precompute_edge_vectors=self.precompute_edge_vectors,
        )

    def _sharded(self, graphs: List[CrystalGraph]) -> Batch:
        """A stacked batch: graphs s, s + S, ... in shard s (strided, so
        a size-sorted batch spreads over the shards), each shard collated at
        one pad and split along the graph axis."""
        raw_lists = [graphs[s::self.num_shards] for s in range(self.num_shards)]
        shard_lists = [gs or graphs[:1] for gs in raw_lists]
        if self.node_shard and self.ring:
            shard_lists = [self._ring_order(gs) for gs in shard_lists]
        pad = self._pick_pad(shard_lists)
        shards = []
        for gs in shard_lists:
            d, t = self._collate(gs, pad)
            if self.num_edge_shards > 1:
                if self.node_shard:
                    d, t = self._shard_nodes_and_edges(d, t)
                else:
                    d = self._shard_edges(d)
                if self.precompute_edge_vectors:
                    # the vectors of the sharded edges
                    attach_edge_vectors(d, dst_local=self.node_shard)
            shards.append((d, t))
        data = {k: np.stack([d[k] for d, _ in shards]) for k in shards[0][0]}
        targets = {k: np.stack([t[k] for _, t in shards]) for k in shards[0][1]}
        # a shard without graphs reuses graphs[:1] with its masks zeroed (and
        # its vectors, which were computed before), so it adds nothing
        for s, gs in enumerate(raw_lists):
            if not gs:
                for key in (K.NODE_MASK, K.EDGE_MASK, K.GRAPH_MASK):
                    data[key][s] = False
                if K.EDGE_VECTORS in data:
                    data[K.EDGE_VECTORS][s] = 0.0
        return data, targets

    def __iter__(self) -> Iterator[Batch]:
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            self._rng.shuffle(idx)
        order = np.arange(len(self))
        if self.batch_by_size:
            sizes = np.array([g.num_edges for g in self.graphs])
            idx = self._size_order(idx, sizes)
            if self.shuffle:
                self._rng.shuffle(order)
        for i in order:
            graphs = [self.graphs[j] for j in idx[i * self.batch_size : (i + 1) * self.batch_size]]
            if self.num_shards == 1 and self.num_edge_shards == 1:
                yield self._collate(graphs, self._pick_pad([graphs]))
            else:
                yield self._sharded(graphs)


class TensorDataModule:
    """Train/val/test datasets + statistics + loaders.

    Takes the `data` section of a train config: the tensor target as irreps
    or flat Cartesian components, scaled, optionally normalized (irreps
    only), with per-crystal weights; scalar targets, optionally logged and
    standardized; atom and global feature columns, optionally standardized.
    `num_shards`, or `set_sharding` (what the scripts call from
    `trainer.devices` / `trainer.mesh`), gives every loader the sharded
    layout of a mesh."""

    # loader_kwargs keys forwarded verbatim to BatchLoader
    _LOADER_PASSTHROUGH = (
        "node_multiple",
        "edge_multiple",
        "num_buckets",
        "node_chunk",
        "drop_last",
        "batch_by_size",
        "precompute_edge_vectors",
    )

    def __init__(
        self,
        trainset_filename: str,
        valset_filename: str,
        testset_filename: str,
        *,
        r_cut: float,
        tensor_target_name: str = "elastic_tensor_full",
        tensor_target_format: str = "irreps",
        tensor_target_formula: str = "ijkl=jikl=klij",
        tensor_target_scale: float = 1.0,
        normalize_tensor_target: bool = False,
        tensor_target_weight: Optional[Dict] = None,
        atom_selector: Optional[str] = None,
        scalar_target_names: Optional[List[str]] = None,
        log_scalar_targets: Optional[List[bool]] = None,
        normalize_scalar_targets: Optional[List[bool]] = None,
        atom_featurizer: Optional[Any] = None,
        global_featurizer: Optional[Any] = None,
        normalize_atom_features: bool = False,
        normalize_global_features: bool = False,
        root: str = ".",
        reuse: bool = True,
        compute_dataset_statistics: bool = True,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        num_shards: int = 1,
    ):
        self._shard_kwargs: Dict[str, Any] = dict(num_shards=num_shards)

        def _cols(spec):
            if spec is None:
                return ()
            if isinstance(spec, str):
                return (spec,)
            return tuple(spec)

        if normalize_tensor_target and tensor_target_format != "irreps":
            # the JAX module's statistics have no normalizer of Cartesian
            # targets either: its setup fails on the missing normalizer
            raise ValueError("normalize_tensor_target needs tensor_target_format: irreps")
        self.cfg = TensorDatasetConfig(
            r_cut=r_cut,
            tensor_target_name=tensor_target_name,
            tensor_target_format=tensor_target_format,
            tensor_target_formula=tensor_target_formula,
            tensor_target_scale=tensor_target_scale,
            atom_selector=atom_selector,
            scalar_target_names=tuple(scalar_target_names or ()),
            log_scalar_targets=tuple(log_scalar_targets or ()),
            tensor_target_weight=tensor_target_weight,
            atom_feats_columns=_cols(atom_featurizer),
            global_feats_columns=_cols(global_featurizer),
        )
        self.normalize_atom_features = normalize_atom_features
        self.normalize_global_features = normalize_global_features
        self.root = Path(root)
        self.filenames = dict(train=trainset_filename, val=valset_filename, test=testset_filename)
        self.normalize_tensor_target = normalize_tensor_target
        self.normalize_scalar_targets = normalize_scalar_targets
        self.reuse = reuse
        self.compute_dataset_statistics = compute_dataset_statistics
        self.loader_kwargs = dict(loader_kwargs or {})
        self.seed = seed
        self.graphs: Dict[str, List[CrystalGraph]] = {}
        self.failed: Dict[str, List[int]] = {}
        self.statistics: Optional[DatasetStatistics] = None
        self.species_map: Optional[np.ndarray] = None

    def _cache_path(self, fname: str) -> Path:
        """Processed-graph cache: `processed/<stem>_<hash>.pkl` under the
        root, the hash over this package's tag, the file name and the
        dataset options the graphs are read with (the JAX package's cache
        in the same root has another hash and is never read)."""
        cfg = self.cfg
        key = hashlib.md5(
            f"{_CACHE_TAG}|{fname}|{cfg.r_cut}|{cfg.tensor_target_name}|{cfg.tensor_target_format}|"
            f"{cfg.tensor_target_formula}|{cfg.atom_selector}|{cfg.scalar_target_names}|"
            f"{cfg.log_scalar_targets}|{cfg.tensor_target_scale}|{cfg.tensor_target_weight}|"
            f"{cfg.atom_feats_columns}|{cfg.global_feats_columns}".encode()
        ).hexdigest()[:12]
        return self.root / "processed" / f"{Path(fname).stem}_{key}.pkl"

    def setup(self) -> None:
        """Read the three files (or their cache), compute the train-set
        statistics and normalize targets and features in place."""
        for split, fname in self.filenames.items():
            cache = self._cache_path(fname)
            if self.reuse and cache.exists():
                with open(cache, "rb") as f:
                    self.graphs[split], self.failed[split] = pickle.load(f)
                logger.info("%s: %d graphs (cached)", split, len(self.graphs[split]))
                continue
            self.graphs[split], self.failed[split] = load_tensor_dataset(self.root / fname, self.cfg)
            try:
                # written aside and renamed: the ranks of a run may read it
                cache.parent.mkdir(parents=True, exist_ok=True)
                tmp = cache.with_name(f"{cache.name}.{os.getpid()}.tmp")
                with open(tmp, "wb") as f:
                    pickle.dump((self.graphs[split], self.failed[split]), f)
                os.replace(tmp, cache)
            except OSError as e:  # read-only dataset roots: skip caching
                logger.debug("graph cache not written (%s)", e)
            logger.info(
                "%s: %d graphs (%d failed rows)", split, len(self.graphs[split]), len(self.failed[split])
            )
        self.statistics = DatasetStatistics.compute(
            self.graphs["train"], self.cfg, self.normalize_tensor_target
        )
        self.species_map = atomic_number_map(self.statistics.allowed_species)
        if self.normalize_tensor_target:
            tn = self.statistics.target_normalizer
            name = self.cfg.tensor_target_name
            for split in self.graphs:
                for g in self.graphs[split]:
                    g.y[name] = np.asarray(tn.forward(g.y[name]))
        for name, do in zip(self.cfg.scalar_target_names, self.normalize_scalar_targets or ()):
            if not do:
                continue
            sn = self.statistics.scalar_normalizers[name]
            for split in self.graphs:
                for g in self.graphs[split]:
                    g.y[name] = np.asarray(sn.forward(np.atleast_2d(g.y[name])))
        # feature normalization with the train-set statistics
        for name, do in (
            ("atom_feats", self.normalize_atom_features),
            ("global_feats", self.normalize_global_features),
        ):
            if not do:
                continue
            fn = self.statistics.feature_normalizers[name]
            for split in self.graphs:
                for g in self.graphs[split]:
                    g.x[name] = np.asarray(fn.forward(np.atleast_2d(g.x[name])))

    def get_to_model_info(self) -> Dict[str, Any]:
        """The dataset -> model hand-off."""

        def _size(name):
            g0 = self.graphs["train"][0]
            return int(np.atleast_2d(g0.x[name]).shape[-1]) if name in g0.x else None

        return {
            "allowed_species": list(self.statistics.allowed_species),
            "average_num_neighbors": self.statistics.average_num_neighbors,
            "global_feats_size": _size("global_feats"),
            "atom_feats_size": _size("atom_feats"),
        }

    def set_sharding(
        self,
        num_shards: int = 1,
        num_edge_shards: int = 1,
        node_shard: bool = False,
        ring: bool = False,
    ) -> None:
        """The batch layout of a (data, graph) mesh for every loader
        (`MeshSpec.loader_kwargs`)."""
        self._shard_kwargs = dict(
            num_shards=num_shards, num_edge_shards=num_edge_shards, node_shard=node_shard, ring=ring
        )

    def _loader(self, split: str, shuffle: bool) -> BatchLoader:
        extra = {k: self.loader_kwargs[k] for k in self._LOADER_PASSTHROUGH if k in self.loader_kwargs}
        return BatchLoader(
            self.graphs[split],
            batch_size=int(self.loader_kwargs.get("batch_size", 32)),
            species_map=self.species_map,
            shuffle=shuffle,
            seed=self.seed,
            **self._shard_kwargs,
            **extra,
        )

    def train_dataloader(self) -> BatchLoader:
        return self._loader("train", shuffle=bool(self.loader_kwargs.get("shuffle", True)))

    def val_dataloader(self) -> BatchLoader:
        return self._loader("val", shuffle=False)

    def test_dataloader(self) -> BatchLoader:
        return self._loader("test", shuffle=False)
