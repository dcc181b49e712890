"""The port's BatchLoader and TensorDataModule against the JAX package's.

- `BatchLoader` on the same graphs and seed yields the batches the JAX
  loader yields with `node_chunk=None` (the port's layout: the JAX
  default chunk-aligns batches above 128 padded nodes for its TPU kernel):
  every key, shape, dtype and value equal, over two epochs with
  `set_epoch`, for each loader option (buckets 1 and 4, `batch_by_size` on
  and off, `drop_last`, a ragged tail, no shuffle, per-atom targets, a
  dataset of one-atom graphs, no precomputed edge vectors); the pad ladders
  are equal; and on bench.py's 128-crystal and 73-species draws, loaded
  as its `build_batch` loads them (one batch of every crystal), the JAX
  loader's batch in its unchunked layout, at the pad shapes the port's
  card phases run (N 1408, E 109568; N 256, E 14848).
- `TensorDataModule.setup` on files pandas writes (an elasticity set with a
  feature column, an NMR set with an atom selector, targets normalized; the
  elasticity set with a logged and standardized scalar target, the tensor
  scaled, weights from a string column and both feature kinds; and with
  Cartesian targets) gives the JAX module's graphs and failed rows
  exactly, its statistics within 1e-12, its dataset hand-off and its
  loaders' batches.
- The graph cache round-trips, and a cache the JAX package wrote in the
  same root is not read.
"""

import dataclasses
import logging

import numpy as np
import pandas as pd
import pytest

from matten_tpu.data.datamodule import BatchLoader as JaxLoader
from matten_tpu.data.datamodule import TensorDataModule as JaxDataModule
from matten_tpu.data.graph import CrystalGraph as JaxGraph
from matten_tpu.data.structure import Structure as JaxStructure
from matten_tpu_torch.data import datamodule as pdm
from matten_tpu_torch.data.datamodule import BatchLoader, TensorDataModule
from matten_tpu_torch.data.graph import CrystalGraph
from matten_tpu_torch.nn.embedding import atomic_number_map

SPECIES = (8, 14)
SMAP = atomic_number_map(SPECIES)


def _jax_graphs(seed, n, atoms=(2, 6), nmr=False):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        k = int(rng.integers(*atoms)) if atoms[1] > atoms[0] else atoms[0]
        s = JaxStructure(
            lattice=np.eye(3) * (3.6 + rng.uniform(0, 1.0)) + rng.normal(size=(3, 3)) * 0.1,
            frac_coords=rng.uniform(0, 1, size=(k, 3)),
            atomic_numbers=rng.choice(SPECIES, size=k),
        )
        g = JaxGraph.from_structure(s, r_cut=5.0)
        if nmr:
            sel = s.atomic_numbers == 14
            g.y["nmr_tensor"] = np.where(sel[:, None], rng.normal(size=(k, 6)), 0.0)
            g.y["atom_selector"] = sel
        else:
            g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
        graphs.append(g)
    return graphs


def _port(graphs):
    """The same graphs as the port's CrystalGraph."""
    return [
        CrystalGraph(**{f.name: getattr(g, f.name) for f in dataclasses.fields(JaxGraph)})
        for g in graphs
    ]


def _pads(loader):
    return [(p.num_nodes, p.num_edges, p.num_graphs, p.node_chunk, p.edge_block) for p in loader.pads]


def _assert_batches_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for (d, t), (jd, jt) in zip(ours, ref):
        for got, want in ((d, jd), (t, jt)):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


CASES = {
    "buckets1": dict(num_buckets=1),
    "buckets4": dict(num_buckets=4),
    "by_size": dict(num_buckets=4, batch_by_size=True),
    "by_size_buckets1_drop_last": dict(num_buckets=1, batch_by_size=True, drop_last=True),
    "drop_last": dict(num_buckets=4, drop_last=True),
    "no_shuffle": dict(num_buckets=4, shuffle=False),
    "no_edge_vectors": dict(num_buckets=4, precompute_edge_vectors=False),
    "nmr": dict(num_buckets=4, nmr=True),
    "one_atom_graphs": dict(num_buckets=4, atoms=(1, 1)),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_batch_loader_matches_jax(case):
    kw = dict(CASES[case])
    nmr, atoms = kw.pop("nmr", False), kw.pop("atoms", (2, 6))
    kw.setdefault("shuffle", True)
    graphs = _jax_graphs(seed=len(case), n=23, atoms=atoms, nmr=nmr)  # 23 = 4 x 5 + a ragged 3
    jl = JaxLoader(graphs, batch_size=5, species_map=SMAP, seed=3, node_chunk=None, **kw)
    pl = BatchLoader(_port(graphs), batch_size=5, species_map=SMAP, seed=3, **kw)
    assert _pads(pl) == _pads(jl)
    assert len(pl) == len(jl) == (4 if kw.get("drop_last") else 5)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        _assert_batches_equal(list(pl), list(jl))


# bench.py's batches beside its flagship: `build_batch(np.random.default_rng(1),
# 128, 8, 14)` (BENCH_EXTRA's large batch) and `build_batch(
# np.random.default_rng(3), species=SPECIES_73)`, one batch of all their
# crystals each; their pad shapes (nodes, edges) as the port collates them
BENCH = {
    "bench128": dict(seed=1, n=128, atoms=(8, 14), species=(8, 13, 14, 22, 56), pad=(1408, 109568)),
    "bench_s73": dict(seed=3, n=32, atoms=(4, 12), species=tuple(range(3, 76)), pad=(256, 14848)),
}


def _bench_graphs(seed, n, atoms, species):
    """The JAX graphs of `bench.py::build_batch`, drawn in its order."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        k = int(rng.integers(atoms[0], atoms[1] + 1))
        s = JaxStructure(
            lattice=np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1,
            frac_coords=rng.uniform(0, 1, size=(k, 3)),
            atomic_numbers=rng.choice(species, size=k),
        )
        g = JaxGraph.from_structure(s, r_cut=5.0)
        g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
        graphs.append(g)
    return graphs


@pytest.mark.parametrize("case", list(BENCH), ids=list(BENCH))
def test_batch_loader_matches_jax_on_bench_batches(case):
    """bench.py's 128-crystal batch and its 73-species batch, loaded as
    `build_batch` loads them (one batch of every crystal, the loader's
    defaults), equal the JAX loader's batch in its unchunked layout."""
    c = BENCH[case]
    graphs = _bench_graphs(c["seed"], c["n"], c["atoms"], c["species"])
    smap = atomic_number_map(c["species"])
    jl = JaxLoader(graphs, batch_size=c["n"], species_map=smap, node_chunk=None)
    pl = BatchLoader(_port(graphs), batch_size=c["n"], species_map=smap)
    assert _pads(pl) == _pads(jl)
    ours, ref = list(pl), list(jl)
    _assert_batches_equal(ours, ref)
    data = ours[0][0]
    assert (data["node_mask"].shape[0], data["edge_index"].shape[1]) == c["pad"]
    assert data["graph_mask"].all() and data["graph_mask"].shape == (c["n"],)
    assert data["species_index"].max() < len(c["species"])


SHARDED = {
    "dp2": dict(num_shards=2),
    "dp4_by_size": dict(num_shards=4, batch_by_size=True),
    "edge2x2": dict(num_shards=2, num_edge_shards=2),
    "edge1x4": dict(num_shards=1, num_edge_shards=4),
    "node2x2": dict(num_shards=2, num_edge_shards=2, node_shard=True),
    "node1x4_nmr": dict(num_shards=1, num_edge_shards=4, node_shard=True, nmr=True),
    "node4x2_no_edge_vectors": dict(num_shards=4, num_edge_shards=2, node_shard=True,
                                    precompute_edge_vectors=False),
    "ring2x2": dict(num_shards=2, num_edge_shards=2, node_shard=True, ring=True),
    "ring1x4": dict(num_shards=1, num_edge_shards=4, node_shard=True, ring=True),
}


def _pad_slots(data, kw):
    """The node layouts' padding slots: [S, Sg, E] of edges no real edge
    fills, and the (src, dst) the port writes there."""
    ei, (s_, sg, cap) = data["edge_index"], data["edge_mask"].shape
    c = data["pos"].shape[2]
    filled = np.zeros((s_, sg, cap), dtype=bool)
    want_src = np.empty((s_, sg, cap), dtype=np.int64)
    for s in range(s_):
        for g in range(sg):
            groups = sg if kw.get("ring") else 1
            cap2 = cap // groups
            for so in range(groups):
                rows = slice(so * cap2, (so + 1) * cap2)
                owner = so if kw.get("ring") else g
                want_src[s, g, rows] = owner * c + c - 1
                # real edges first in each slot group: dst non-decreasing, in the owner's chunk
                src, dst = ei[s, g, 0, rows], ei[s, g, 1, rows]
                assert (np.diff(dst) >= 0).all() and dst.min() >= 0 and dst.max() < c
                if kw.get("ring"):
                    assert ((src >= so * c) & (src < (so + 1) * c)).all()
                else:
                    assert ((src >= 0) & (src < sg * c)).all()
    return want_src, c


@pytest.mark.parametrize("case", list(SHARDED), ids=list(SHARDED))
def test_sharded_batch_loader_matches_jax(case):
    """The stacked layouts, every field equal to the JAX loader's except the
    index slots the port rewrites: the node layouts' padding slots, which
    hold dst = c - 1 and a src in the slot owner's chunk (the JAX layout's
    0 breaks the kernels' sorted-dst contract), checked inert: edge mask
    False, cell shift 1e6, edge vector 0."""
    kw = dict(SHARDED[case])
    nmr = kw.pop("nmr", False)
    # 19 = 2 x 8 + 3: the last batch of 4 shards leaves one shard without graphs
    graphs = _jax_graphs(seed=len(case), n=19, nmr=nmr)
    jl = JaxLoader(graphs, batch_size=8, species_map=SMAP, seed=3, shuffle=True, node_chunk=None, **kw)
    pl = BatchLoader(_port(graphs), batch_size=8, species_map=SMAP, seed=3, shuffle=True, **kw)
    assert _pads(pl) == _pads(jl)
    node = kw.get("node_shard", False)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        ours, ref = list(pl), list(jl)
        assert len(ours) == len(ref) == 3
        for (d, t), (jd, jt) in zip(ours, ref):
            assert d["pos"].shape[0] == kw["num_shards"]
            if node:
                want_src, c = _pad_slots(d, kw)
                pad = d["edge_index"] != jd["edge_index"]
                assert pad[:, :, 1].any()
                # what differs is the padding the port rewrote, and it is inert
                assert not (pad.any(axis=2) & d["edge_mask"]).any()
                src_pad, dst_pad = pad[:, :, 0], pad[:, :, 1]
                np.testing.assert_array_equal(d["edge_index"][:, :, 0][src_pad], want_src[src_pad])
                assert (d["edge_index"][:, :, 1][dst_pad] == c - 1).all()
                assert (jd["edge_index"][pad] == 0).all()
                pads = ~jd["edge_mask"] & (jd["edge_cell_shift"] == 1e6).all(-1)
                assert (pad.any(axis=2) <= pads).all()
                d = dict(d, edge_index=jd["edge_index"])
            _assert_batches_equal([(d, t)], [(jd, jt)])


@pytest.mark.parametrize("ring", [False, True], ids=["node", "ring"])
def test_node_layouts_shard_atom_features(ring):
    """A per-atom feature column is sharded with its nodes, [S, Sg, c, F]
    (the JAX layout leaves it [S, N, F], which its sharded step cannot
    read); per-graph columns stay whole."""
    rng = np.random.default_rng(5)
    graphs = _port(_jax_graphs(seed=6, n=8))
    for g in graphs:
        g.x["atom_feats"] = rng.normal(size=(g.num_nodes, 2))
        g.x["global_feats"] = rng.normal(size=(1, 3))
    plain = next(iter(BatchLoader(graphs, batch_size=8, species_map=SMAP, num_buckets=1)))[0]
    data = next(iter(BatchLoader(graphs, batch_size=8, species_map=SMAP, num_buckets=1, num_edge_shards=2,
                                 node_shard=True, ring=ring)))[0]
    n = plain["atom_feats"].shape[0]
    assert data["atom_feats"].shape == (1, 2, n // 2, 2) and data["global_feats"].shape == (1,) + plain[
        "global_feats"].shape
    if not ring:  # the ring layout orders the graphs by size first
        np.testing.assert_array_equal(data["atom_feats"].reshape(n, 2), plain["atom_feats"])


@pytest.mark.parametrize("ring", [False, True], ids=["node", "ring"])
def test_sharded_edge_vectors_equal_in_graph_vectors(ring):
    """`attach_edge_vectors(dst_local=True)` on the node layouts equals the
    model's in-graph vectors from the gathered positions (`POS_FULL`, src
    global, dst local), shard by shard."""
    import torch

    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.nn.edge_geometry import with_edge_vectors

    graphs = _port(_jax_graphs(seed=4, n=8))
    kw = dict(num_edge_shards=2, node_shard=True, ring=ring)
    with_vec = next(iter(BatchLoader(graphs, batch_size=8, species_map=SMAP, **kw)))[0]
    without = next(iter(BatchLoader(graphs, batch_size=8, species_map=SMAP, precompute_edge_vectors=False,
                                    **kw)))[0]
    assert K.EDGE_VECTORS not in without
    pos_full = torch.as_tensor(without["pos"][0]).reshape(-1, 3)
    for g in range(2):
        sharded = (K.POSITIONS, K.BATCH, K.EDGE_INDEX, K.EDGE_MASK, K.EDGE_CELL_SHIFT)
        shard = {k: torch.as_tensor(without[k][0, g] if k in sharded else without[k][0])
                 for k in sharded + (K.CELL,)}
        shard[K.POS_FULL] = pos_full
        with_edge_vectors(shard)
        np.testing.assert_allclose(shard[K.EDGE_VECTORS].numpy(), with_vec[K.EDGE_VECTORS][0, g], atol=1e-5)
        assert not with_vec[K.EDGE_VECTORS][0, g][~with_vec[K.EDGE_MASK][0, g]].any()


def test_node_chunk_takes_only_no_chunking():
    graphs = _port(_jax_graphs(seed=1, n=6))
    for chunk in (None, "auto"):
        BatchLoader(graphs, batch_size=2, species_map=SMAP, node_chunk=chunk)
    with pytest.raises(ValueError, match="TPU layout"):
        BatchLoader(graphs, batch_size=2, species_map=SMAP, node_chunk=128)


def test_batch_by_size_single_window_warns(caplog):
    """Mirrors tests/data/test_data_layer.py: one sort window warns."""
    graphs = _port(_jax_graphs(seed=15, n=6))
    with caplog.at_level(logging.WARNING):
        BatchLoader(graphs, batch_size=4, species_map=SMAP, batch_by_size=True)
    assert any("batch membership" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        BatchLoader(graphs, batch_size=1, species_map=SMAP, batch_by_size=True)
    assert not any("batch membership" in r.message for r in caplog.records)


# ---------------------------------------------------------------- data module


def _symmetric_elastic(rng):
    t = rng.normal(size=(3, 3, 3, 3))
    t = (t + t.transpose(1, 0, 2, 3)) / 2
    t = (t + t.transpose(0, 1, 3, 2)) / 2
    return (t + t.transpose(2, 3, 0, 1)) / 2


def _write(path, kind, n, seed):
    """A pandas-written dataset file (orient "columns", pandas' default)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = int(rng.integers(2, 5))
        z = rng.choice(SPECIES, size=k)
        z[0] = 14
        s = JaxStructure(np.eye(3) * (3.8 + rng.uniform(0, 1.0)) + rng.normal(size=(3, 3)) * 0.1,
                         rng.uniform(0, 1, size=(k, 3)), z)
        row = {"structure": s.to_dict()}
        if kind in ("elasticity", "variants"):
            row["elastic_tensor_full"] = (_symmetric_elastic(rng) * 50.0 + 10.0).tolist()
            row["density"] = float(rng.uniform(1.0, 5.0))
            if kind == "variants":
                row["k_voigt"] = float(rng.uniform(20.0, 200.0))
                row["site_feats"] = rng.normal(size=k).tolist()
                row["source"] = ["dft", "exp"][i % 2]
        else:
            sel = z == 14
            t = rng.normal(size=(int(sel.sum()), 3, 3)) * 20.0 + 300.0
            row["nmr_tensor"] = ((t + t.transpose(0, 2, 1)) / 2).tolist()
            # one bad row: a selector that does not match the atom count
            row["atom_selector"] = sel.tolist() + ([True] if i == 3 else [])
        rows.append(row)
    pd.DataFrame(rows).to_json(path)


DATA = {
    "elasticity": dict(tensor_target_name="elastic_tensor_full", global_featurizer="density",
                       normalize_global_features=True),
    "nmr": dict(tensor_target_name="nmr_tensor", tensor_target_formula="ij=ji", atom_selector="atom_selector"),
    # the target options: a logged, standardized scalar target, the tensor
    # scaled, weights picked by a string column, both feature kinds
    "variants": dict(tensor_target_name="elastic_tensor_full", scalar_target_names=["k_voigt"],
                     log_scalar_targets=[True], normalize_scalar_targets=[True], tensor_target_scale=0.1,
                     tensor_target_weight={"source": {"dft": 1.0, "exp": 2.5}},
                     atom_featurizer="site_feats", global_featurizer="density",
                     normalize_atom_features=True, normalize_global_features=True),
    # the Cartesian format: 81 flat components, which have no normalizer
    "cartesian": dict(tensor_target_name="elastic_tensor_full", tensor_target_format="cartesian",
                      normalize_tensor_target=False),
}


def _data_config(tmp_path, kind, reuse=False):
    file_kind = "elasticity" if kind == "cartesian" else kind
    for split, (n, seed) in {"train": (10, 1), "val": (6, 2), "test": (5, 3)}.items():
        if not (tmp_path / f"{file_kind}_{split}.json").exists():
            _write(tmp_path / f"{file_kind}_{split}.json", file_kind, n, seed)
    return dict({"normalize_tensor_target": True, **DATA[kind]}, root=str(tmp_path), r_cut=4.0, reuse=reuse,
                trainset_filename=f"{file_kind}_train.json", valset_filename=f"{file_kind}_val.json",
                testset_filename=f"{file_kind}_test.json",
                loader_kwargs=dict(batch_size=4, num_buckets=2, node_chunk=None))


@pytest.mark.parametrize("kind", list(DATA))
def test_data_module_matches_jax(tmp_path, kind):
    cfg = _data_config(tmp_path, kind)
    jdm, pdm_ = JaxDataModule(**cfg, seed=5), TensorDataModule(**cfg, seed=5)
    jdm.setup()
    pdm_.setup()
    assert pdm_.failed == jdm.failed
    assert (pdm_.failed["train"] == [3]) == (kind == "nmr")
    for split in ("train", "val", "test"):
        assert len(pdm_.graphs[split]) == len(jdm.graphs[split]) > 0
        for g, jg in zip(pdm_.graphs[split], jdm.graphs[split]):
            for f in dataclasses.fields(JaxGraph):
                a, b = getattr(g, f.name), getattr(jg, f.name)
                if isinstance(b, dict):
                    assert sorted(a) == sorted(b)
                    for k in b:
                        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name}[{k}]")
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f.name)
    ours, ref = pdm_.statistics.to_arrays(), jdm.statistics.to_arrays()
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-12, atol=1e-12, err_msg=k)
    assert pdm_.get_to_model_info() == jdm.get_to_model_info()
    np.testing.assert_array_equal(pdm_.species_map, jdm.species_map)
    for name in ("train_dataloader", "val_dataloader", "test_dataloader"):
        pl, jl = getattr(pdm_, name)(), getattr(jdm, name)()
        assert _pads(pl) == _pads(jl)
        pl.set_epoch(1)
        jl.set_epoch(1)
        _assert_batches_equal(list(pl), list(jl))


def test_graph_cache_round_trips_and_skips_the_jax_cache(tmp_path, monkeypatch):
    cfg = _data_config(tmp_path, "elasticity", reuse=True)
    # the JAX package's cache, written first into the same root
    JaxDataModule(**cfg).setup()
    jax_files = sorted((tmp_path / "processed").iterdir())
    assert len(jax_files) == 3
    first = TensorDataModule(**cfg)
    first.setup()
    files = sorted(set((tmp_path / "processed").iterdir()) - set(jax_files))
    assert len(files) == 3 and all(f.suffix == ".pkl" for f in files)
    assert all(type(g) is CrystalGraph for split in first.graphs.values() for g in split)

    def no_reading(*args, **kwargs):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(pdm, "load_tensor_dataset", no_reading)
    second = TensorDataModule(**cfg)
    second.setup()
    for split in first.graphs:
        assert len(second.graphs[split]) == len(first.graphs[split])
        for a, b in zip(second.graphs[split], first.graphs[split]):
            assert type(a) is CrystalGraph
            np.testing.assert_array_equal(a.pos, b.pos)
            np.testing.assert_array_equal(a.edge_index, b.edge_index)
    np.testing.assert_allclose(second.statistics.to_arrays()["target_mean"],
                               first.statistics.to_arrays()["target_mean"], rtol=0, atol=0)


def test_data_module_refuses_what_is_not_ported(tmp_path):
    """The target options are taken (their parity is `test_data_module_matches_jax`'s
    "variants" and "cartesian" cases), and the sharded layouts: `num_shards`
    and `set_sharding` give every loader a stacked layout, the JAX
    module's. What still raises: the TPU's chunk-aligned layout (an integer
    `node_chunk`), and a normalizer of Cartesian targets, which the JAX
    module's statistics lack too."""
    cfg = _data_config(tmp_path, "elasticity")
    for extra in (dict(tensor_target_format="cartesian", normalize_tensor_target=False),
                  dict(scalar_target_names=["density"], log_scalar_targets=[True],
                       normalize_scalar_targets=[True]),
                  dict(tensor_target_scale=2.0), dict(tensor_target_weight={"density": {}})):
        TensorDataModule(**dict(cfg, **extra))
    dm = TensorDataModule(**cfg, num_shards=2)
    dm.setup()
    assert dm.train_dataloader().num_shards == 2
    assert next(iter(dm.val_dataloader()))[0]["pos"].shape[0] == 2
    dm.set_sharding(num_shards=1, num_edge_shards=2, node_shard=True, ring=True)
    loader = dm.test_dataloader()
    assert (loader.num_shards, loader.num_edge_shards, loader.node_shard, loader.ring) == (1, 2, True, True)
    assert next(iter(loader))[0]["pos"].shape[:2] == (1, 2)
    with pytest.raises(ValueError, match="tensor_target_format: irreps"):
        TensorDataModule(**dict(cfg, tensor_target_format="cartesian"))
    dm = TensorDataModule(**dict(cfg, loader_kwargs=dict(batch_size=4, node_chunk=128)))
    dm.setup()
    with pytest.raises(ValueError, match="node_chunk"):
        dm.train_dataloader()