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
is absent, None or "auto", all meaning no chunking. The sharded layouts of
the JAX loader (data parallelism and graph partitioning) are not ported
yet.
"""

from __future__ import annotations

import hashlib
import logging
import pickle
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from matten_tpu_torch.data.dataset import DatasetStatistics, TensorDatasetConfig, load_tensor_dataset
from matten_tpu_torch.data.graph import CrystalGraph, PadSpec, collate_graphs
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
        node_chunk: Union[str, None] = None,
        num_buckets: int = 4,
        batch_by_size: bool = False,
        precompute_edge_vectors: bool = True,
    ):
        """num_buckets > 1 builds a small ladder of pad shapes sized from the
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
                "loader's other layouts are ROADMAP item 6"
            )
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

        # worst-case bucket: the k largest graphs in one batch
        sizes = np.sort(np.array([g.num_nodes for g in graphs]))[::-1]
        esizes = np.sort(np.array([g.num_edges for g in graphs]))[::-1]
        k = min(batch_size, len(graphs))
        n_max = int(sizes[:k].sum())
        e_max = int(esizes[:k].sum())
        self.pad = self._make_pad(n_max, e_max)

        # bucket ladder: the batch sums of 128 simulated epochs of the same
        # pipeline (shuffle [-> window sort] -> carve batches), drawn from a
        # fixed generator so every epoch sees the same ladder; the worst
        # case is the last level
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
                    bn, be = int(arr_n[b].sum()), int(arr_e[b].sum())
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
        """Pad spec for raw totals (n nodes, e edges): at least one padding
        node, both rounded up to their multiples, a graph slot per graph."""
        return PadSpec(
            self._round(n + 1, self.node_multiple),
            self._round(max(e, 1), self.edge_multiple),
            self.batch_size,
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

    def _pick_pad(self, graphs: List[CrystalGraph]) -> PadSpec:
        """The smallest ladder level that fits the batch."""
        n = sum(g.num_nodes for g in graphs)
        e = sum(g.num_edges for g in graphs)
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
            yield collate_graphs(
                graphs,
                self._pick_pad(graphs),
                species_map=self.species_map,
                per_node_keys=self._per_node_keys,
                precompute_edge_vectors=self.precompute_edge_vectors,
            )


class TensorDataModule:
    """Train/val/test datasets + statistics + loaders.

    Takes the `data` section of a train config: the tensor target as irreps
    or flat Cartesian components, scaled, optionally normalized (irreps
    only), with per-crystal weights; scalar targets, optionally logged and
    standardized; atom and global feature columns, optionally standardized.
    The sharded layouts (`num_shards` other than 1) raise
    `NotImplementedError`."""

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
        if num_shards != 1:
            raise NotImplementedError(
                f"num_shards={num_shards}: the sharded batch layouts are not ported "
                "yet (ROADMAP item 6)"
            )

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
                cache.parent.mkdir(parents=True, exist_ok=True)
                with open(cache, "wb") as f:
                    pickle.dump((self.graphs[split], self.failed[split]), f)
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

    def set_sharding(self, *args, **kwargs) -> None:
        raise NotImplementedError("the sharded batch layouts are not ported yet (ROADMAP item 6)")

    def _loader(self, split: str, shuffle: bool) -> BatchLoader:
        extra = {k: self.loader_kwargs[k] for k in self._LOADER_PASSTHROUGH if k in self.loader_kwargs}
        return BatchLoader(
            self.graphs[split],
            batch_size=int(self.loader_kwargs.get("batch_size", 32)),
            species_map=self.species_map,
            shuffle=shuffle,
            seed=self.seed,
            **extra,
        )

    def train_dataloader(self) -> BatchLoader:
        return self._loader("train", shuffle=bool(self.loader_kwargs.get("shuffle", True)))

    def val_dataloader(self) -> BatchLoader:
        return self._loader("val", shuffle=False)

    def test_dataloader(self) -> BatchLoader:
        return self._loader("test", shuffle=False)
