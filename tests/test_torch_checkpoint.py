"""The port's dataset reader, statistics, checkpoints and predict-from-disk
against the JAX package on the CPU.

- `load_tensor_dataset` reads files that pandas writes (its default orient
  "columns" and orient "records"), an elasticity set of 12 rows with atom
  and global feature columns and a NaN feature in one row, and an NMR set
  with one bad row, the elasticity rows with a `k_voigt` column (logged)
  and a string column picking target weights, the tensor scaled, and the
  Cartesian target format, without pandas: graphs, targets, features,
  weights, selectors and failed rows exactly equal to the JAX package's.
- `DatasetStatistics.to_arrays` (target, scalar-target and feature
  normalizers) within 1e-12 of the JAX package's, and the save / load
  round trip.
- `CheckpointManager`: best-k pruning, `last`, the loop state, a strict
  reload of a `Trainer` and `load_pretrained`'s choice of the best epoch.
- A model trained with the JAX package, saved by its `CheckpointManager`,
  restored with orbax and converted with `convert_checkpoint`, served by
  the port's `predict(structures, directory)`: both families and a
  multi-task model (a `k_voigt` head beside the tensor), with a target
  normalizer, within rtol=atol=1e-4 of the JAX `predict(structures,
  jax_directory)` (float32 with another summation order), and equal to the
  port's in-memory `predict` of the same weights. A model that reads
  feature columns is refused where the JAX `predict` fails.
"""

import json

import jax
import numpy as np
import orbax.checkpoint as ocp
import pandas as pd
import pytest
import torch

from matten_tpu.data import dataset as jdataset
from matten_tpu.data.graph import CrystalGraph as JaxGraph
from matten_tpu.data.graph import collate_graphs as jax_collate
from matten_tpu.data.graph import pad_spec_for as jax_pad_spec
from matten_tpu.data.structure import Structure as JaxStructure
from matten_tpu.data.transform import MeanNormNormalize as JaxNormalize
from matten_tpu.data.transform import ScalarNormalize as JaxScalarNormalize
from matten_tpu.models import create_atomic_tensor_model as jax_create_atomic
from matten_tpu.models import create_scalar_tensor_model as jax_create_scalar
from matten_tpu.nn.embedding import atomic_number_map as jax_species_map
from matten_tpu.ops.cartesian import cartesian_tensor_map as jax_cartesian_map
from matten_tpu.predict import predict as jax_predict
from matten_tpu.train import CanonicalRegressionTask as JaxTask
from matten_tpu.train import Trainer as JaxTrainer
from matten_tpu.train import TrainerConfig as JaxConfig
from matten_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from matten_tpu.train.checkpoint import load_sidecar as jax_load_sidecar
from matten_tpu.train.checkpoint import save_sidecar as jax_save_sidecar
from matten_tpu_torch.convert import convert_checkpoint
from matten_tpu_torch.data import dataset as pdataset
from matten_tpu_torch.data.graph import CrystalGraph, collate_graphs, pad_spec_for
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.data.transform import ScalarNormalize
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.predict import batch_to_device, load_pretrained, model_from_sidecar, predict
from matten_tpu_torch.train import (
    CanonicalRegressionTask,
    CheckpointManager,
    Trainer,
    TrainerConfig,
    save_sidecar,
)

torch.set_num_threads(2)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SPECIES = (8, 14)
NMR_DATA = {"r_cut": 5.0, "tensor_target_name": "nmr_tensor", "tensor_target_formula": "ij=ji",
            "atom_selector": "atom_selector"}
ELASTIC_DATA = {"r_cut": 5.0, "tensor_target_name": "elastic_tensor_full"}


def _structure(rng, k=None):
    k = int(rng.integers(2, 5)) if k is None else k
    z = rng.choice(SPECIES, size=k)
    z[0] = 14
    return JaxStructure(
        lattice=np.eye(3) * (3.8 + rng.uniform(0, 1.0)) + rng.normal(size=(3, 3)) * 0.1,
        frac_coords=rng.uniform(0, 1, size=(k, 3)),
        atomic_numbers=z,
    )


def _symmetric_elastic(rng):
    t = rng.normal(size=(3, 3, 3, 3))
    t = (t + t.transpose(1, 0, 2, 3)) / 2
    t = (t + t.transpose(0, 1, 3, 2)) / 2
    return (t + t.transpose(2, 3, 0, 1)) / 2


def _rows(kind, n, seed):
    """Dataset rows as pymatgen-style dicts and nested lists; the
    "variants" rows add a positive scalar target and a string column."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        s = _structure(rng)
        row = {"structure": s.to_dict()}
        if kind != "nmr":
            row["elastic_tensor_full"] = _symmetric_elastic(rng).tolist()
            feats = rng.normal(size=(len(s), 2))
            if i == 5:  # one bad row: a NaN atom feature
                feats[0, 1] = np.nan
            row["site_feats"] = feats.tolist()
            row["density"] = float(rng.uniform(1.0, 5.0))
            if kind == "variants":
                row["k_voigt"] = [float(rng.uniform(20.0, 200.0))]
                row["source"] = ["dft", "exp", "fit"][i % 3]
        else:
            sel = np.asarray(s.atomic_numbers) == 14
            t = rng.normal(size=(int(sel.sum()), 3, 3))
            row["nmr_tensor"] = ((t + t.transpose(0, 2, 1)) / 2).tolist()
            # one bad row: a selector that does not match the atom count
            row["atom_selector"] = sel.tolist() + ([True] if i == 2 else [])
        rows.append(row)
    return rows


def _cfgs(kind):
    kw = dict(r_cut=5.0)
    if kind != "nmr":
        kw.update(atom_feats_columns=("site_feats",), global_feats_columns=("density",))
    if kind == "cartesian":
        kw.update(tensor_target_format="cartesian")
    elif kind == "variants":
        kw.update(scalar_target_names=("k_voigt",), log_scalar_targets=(True,), tensor_target_scale=0.1,
                  tensor_target_weight={"source": {"dft": 1.0, "exp": 2.0, "fit": 0.5}})
    elif kind == "nmr":
        kw.update(tensor_target_name="nmr_tensor", tensor_target_formula="ij=ji",
                  atom_selector="atom_selector")
    return jdataset.TensorDatasetConfig(**kw), pdataset.TensorDatasetConfig(**kw)


@pytest.fixture(scope="module", params=["elasticity", "nmr", "variants", "cartesian"])
def dataset_files(request, tmp_path_factory):
    kind = request.param
    d = tmp_path_factory.mktemp(kind)
    seed = len("elasticity") if kind == "cartesian" else len(kind)  # the elasticity rows
    df = pd.DataFrame(_rows(kind, 5 if kind == "nmr" else 12, seed=seed))
    df.to_json(d / "columns.json")
    df.to_json(d / "records.json", orient="records")
    return kind, d


@pytest.mark.parametrize("layout", ["columns.json", "records.json"])
def test_dataset_reader_matches_jax_on_pandas_files(dataset_files, layout):
    kind, d = dataset_files
    jcfg, pcfg = _cfgs(kind)
    bad = 2 if kind == "nmr" else 5
    with pytest.warns(UserWarning):
        jg, jf = jdataset.load_tensor_dataset(d / layout, jcfg)
    with pytest.warns(UserWarning, match=f"structure {bad}"):
        pg, pf = pdataset.load_tensor_dataset(d / layout, pcfg)
    assert pf == jf == [bad]
    assert len(pg) == len(jg) == (4 if kind == "nmr" else 11)
    for j, p in zip(jg, pg):
        for name in ("pos", "edge_index", "edge_cell_shift", "cell", "num_neigh", "atomic_numbers"):
            np.testing.assert_array_equal(getattr(p, name), getattr(j, name), err_msg=name)
        assert sorted(p.y) == sorted(j.y) and sorted(p.x) == sorted(j.x)
        assert sorted(p.x) == {"nmr": [], "variants": ["atom_feats", "global_feats", "target_weight"]}.get(
            kind, ["atom_feats", "global_feats"])
        for k in j.y:
            assert p.y[k].dtype == j.y[k].dtype, k
            np.testing.assert_array_equal(p.y[k], j.y[k], err_msg=k)
        for k in j.x:
            assert p.x[k].dtype == j.x[k].dtype, k
            np.testing.assert_array_equal(p.x[k], j.x[k], err_msg=k)
    if kind != "nmr":
        assert pg[0].x["atom_feats"].shape == (pg[0].num_nodes, 2) and pg[0].x["global_feats"].shape == (1, 1)
        assert pg[0].y["elastic_tensor_full"].shape == (1, 81 if kind == "cartesian" else 21)
    if kind == "variants":
        assert [g.x["target_weight"][0, 0] for g in pg[:3]] == [1.0, 2.0, 0.5]
        assert pg[0].y["k_voigt"].shape == (1, 1)
    if kind == "nmr":
        sel = pg[0].y["atom_selector"]
        assert sel.dtype == bool and not pg[0].y["nmr_tensor"][~sel].any()


def test_read_table_keeps_pandas_row_order_and_numbers(tmp_path):
    """Rows keyed "0" .. "11" come in pandas' order (not the keys' string
    order); every float is the one pandas' decoder gives."""
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"v": [rng.normal(size=4).tolist() for _ in range(12)],
                       "s": rng.normal(size=12) * 1e-7, "k": np.arange(12)})
    for orient in ("columns", "records"):
        df.to_json(tmp_path / "t.json", orient=orient)
        rows = pdataset.read_table(tmp_path / "t.json")
        ref = pd.read_json(tmp_path / "t.json").to_dict(orient="records")
        assert [r["k"] for r in rows] == [r["k"] for r in ref] == list(range(12))
        for r, q in zip(rows, ref):
            assert r["v"] == q["v"] and r["s"] == q["s"]


def test_statistics_match_jax_and_round_trip(dataset_files, tmp_path):
    kind, d = dataset_files
    jcfg, pcfg = _cfgs(kind)
    with pytest.warns(UserWarning):
        jg, _ = jdataset.load_tensor_dataset(d / "columns.json", jcfg)
        pg, _ = pdataset.load_tensor_dataset(d / "columns.json", pcfg)
    ja = jdataset.DatasetStatistics.compute(jg, jcfg, normalize_tensor_target=True).to_arrays()
    stats = pdataset.DatasetStatistics.compute(pg, pcfg, normalize_tensor_target=True)
    pa = stats.to_arrays()
    # Cartesian targets have no normalizer, in both packages
    assert sorted(pa) == sorted(ja) and ("target_mean" in pa) == (kind != "cartesian")
    feats = {"feat_atom_feats_mean", "feat_atom_feats_std", "feat_global_feats_mean", "feat_global_feats_std"}
    assert feats <= set(pa) if kind != "nmr" else not feats & set(pa)
    assert ({"scalar_k_voigt_mean", "scalar_k_voigt_std"} <= set(pa)) == (kind == "variants")
    for k in ja:
        np.testing.assert_allclose(pa[k], ja[k], rtol=1e-12, atol=1e-12, err_msg=k)
    stats.save(tmp_path / "stats.npz")
    back = pdataset.DatasetStatistics.load(tmp_path / "stats.npz", pcfg)
    assert back.allowed_species == stats.allowed_species == SPECIES
    for k, v in back.to_arrays().items():
        np.testing.assert_array_equal(v, pa[k], err_msg=k)
    if kind != "cartesian":
        np.testing.assert_array_equal(back.target_normalizer.norm, stats.target_normalizer.norm)
    assert sorted(back.feature_normalizers) == sorted(stats.feature_normalizers)
    assert sorted(back.scalar_normalizers) == sorted(stats.scalar_normalizers)


def test_sidecar_refuses_unported_target_options():
    """The target options are ported: a sidecar naming scalar targets
    builds the model with their heads (the sidecar's `model` section, as
    the JAX script writes it, does not name them), the Cartesian format is
    read into the dataset config, and scalar normalizers round-trip. A
    sidecar that names graph parallelism builds the graph-parallel model
    (the one-device model's parameters); its forward outside a process
    group fails with a message, where the JAX `apply` fails on an unbound
    axis name."""
    hp = {"model": TINY, "dataset_hparams": TINY_DS}
    sn = ScalarNormalize(num_features=1, mean=np.asarray([3.5]), std=np.asarray([0.25]))
    arrays = pdataset.DatasetStatistics(allowed_species=SPECIES, scalar_normalizers={"k_voigt": sn}).to_arrays()
    assert sorted(arrays) == ["allowed_species", "average_num_neighbors", "scalar_k_voigt_mean",
                              "scalar_k_voigt_std"]
    model, cfg, stats = model_from_sidecar(
        dict(hp, data=dict(ELASTIC_DATA, tensor_target_format="cartesian", scalar_target_names=["k_voigt"])),
        arrays, "cpu")
    assert cfg.tensor_target_format == "cartesian" and model.scalar_target_names == ("k_voigt",)
    assert "w_k_voigt" in model.state_dict() and "w_out" in model.state_dict()
    np.testing.assert_array_equal(stats.scalar_normalizers["k_voigt"].std, sn.std)
    np.testing.assert_array_equal(stats.scalar_normalizers["k_voigt"].mean, sn.mean)
    parallel_hp = dict(TINY, graph_parallel_axis="graph", graph_parallel_mode="node")
    model, _, _ = model_from_sidecar(dict(hp, model=parallel_hp, data=ELASTIC_DATA), arrays, "cpu")
    plain, _, _ = model_from_sidecar(dict(hp, data=ELASTIC_DATA), arrays, "cpu")
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}
    data, _ = _tiny_batch()
    with pytest.raises(ValueError, match="unbound axis name 'graph'"):
        model(data)
    jax_model = jax_create_scalar(parallel_hp, TINY_DS)
    numpy_data = {k: v.numpy() for k, v in data.items()}
    variables = jax_model.init(jax.random.PRNGKey(0), numpy_data)
    with pytest.raises(NameError, match="unbound axis name: graph"):
        jax_model.apply(variables, numpy_data, use_running_average=True)


# ---------------------------------------------------------------- checkpoints

TINY = dict(species_embedding_dim=4, irreps_edge_sh="0e+1o+2e", num_layers=1, invariant_layers=1,
            invariant_neurons=4, average_num_neighbors=20.0,
            conv_layer_irreps="2x0o+2x0e+1x1o+1x1e+1x2e", normalization="batch",
            conv_to_output_hidden_irreps_out="2x0e+2e+4e")
TINY_DS = dict(allowed_species=list(SPECIES), average_num_neighbors=20.0)


def _tiny_trainer(seed):
    model = create_scalar_tensor_model(TINY, TINY_DS, device="cpu", seed=seed)
    return Trainer(model, [CanonicalRegressionTask(name="elastic_tensor_full")],
                   TrainerConfig(lr=0.01), device="cpu")


def _tiny_batch(seed=0):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(3):
        s = _structure(rng)
        g = CrystalGraph.from_structure(Structure(s.lattice, s.frac_coords, s.atomic_numbers), r_cut=5.0)
        g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
        graphs.append(g)
    data, targets = collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(SPECIES))
    return batch_to_device(data, "cpu", targets)


def _assert_state_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _assert_state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_state_equal(x, y)
    else:
        assert a == b


def test_checkpoint_manager_best_k_last_loop_state_and_strict_reload(tmp_path):
    batch = _tiny_batch()
    trainer = _tiny_trainer(seed=1)
    manager = CheckpointManager(tmp_path, save_top_k=2)
    saved = {}
    for epoch, score in enumerate([3.0, 1.0, 2.0, 0.5]):
        trainer.train_step(*batch)
        trainer.scheduler.step(score)
        manager.save(epoch, trainer.state_dict(), {"val/score": score})
        saved[epoch] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    assert sorted(p.name for p in tmp_path.glob("epoch_*")) == ["epoch_1", "epoch_3"]
    assert json.loads((tmp_path / "index.json").read_text()) == {"1": 1.0, "3": 0.5}
    assert manager.best_epoch == 3 and CheckpointManager(tmp_path).best_epoch == 3

    trainer.train_step(*batch)
    trainer.scheduler.step(0.9)
    loop = {"epoch": 4, "best": 0.5, "bad_epochs": 1}
    manager.save_last(trainer.state_dict(), loop)
    assert manager.has_last() and not (tmp_path / "last_tmp").exists()
    assert manager.load_loop_state() == loop

    # a strict reload into a fresh trainer: the next steps are the same
    fresh = _tiny_trainer(seed=2)
    fresh.load_state_dict(manager.restore(last=True))
    _assert_state_equal(fresh.state_dict(), trainer.state_dict())
    assert fresh.scheduler == trainer.scheduler and (fresh.scheduler.best, fresh.scheduler.num_bad) == (0.5, 1)
    for _ in range(2):
        assert torch.equal(fresh.train_step(*batch)[0], trainer.train_step(*batch)[0])
    best = manager.restore()
    _assert_state_equal(best["model"], saved[3])
    other = create_scalar_tensor_model(dict(TINY, num_layers=2), TINY_DS, device="cpu")
    with pytest.raises(RuntimeError, match="state_dict"):
        other.load_state_dict(best["model"])

    # load_pretrained takes the best epoch over `last`
    save_sidecar(tmp_path, {"model": TINY, "data": ELASTIC_DATA, "dataset_hparams": TINY_DS,
                            "normalize_tensor_target": False},
                 pdataset.DatasetStatistics(allowed_species=SPECIES).to_arrays())
    model, cfg, stats, normalize = load_pretrained(tmp_path, device="cpu")
    _assert_state_equal(model.state_dict(), saved[3])
    assert not model.training and not cfg.per_atom and not normalize and stats.allowed_species == SPECIES

    (tmp_path / "loop_state.json").write_text("{not json")
    assert manager.load_loop_state() is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


def test_trainer_state_refuses_another_scheduler_config():
    state = _tiny_trainer(seed=1).state_dict()
    assert state["scheduler"]["scale"] == 1.0
    model = create_scalar_tensor_model(TINY, TINY_DS, device="cpu")
    plain = Trainer(model, [CanonicalRegressionTask(name="elastic_tensor_full")],
                    TrainerConfig(scheduler="none"), device="cpu")
    assert plain.state_dict()["scheduler"] is None
    with pytest.raises(ValueError, match="scheduler"):
        plain.load_state_dict(state)


# ---------------------------------------------- JAX checkpoint -> port predict

FAMILIES = {
    "elasticity": dict(
        model=dict(TINY, num_layers=2, species_embedding_dim=8, invariant_layers=2, invariant_neurons=8,
                   conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+1x2o+1x2e",
                   conv_to_output_hidden_irreps_out="4x0e+2x2e+4e", output_formula="ijkl=jikl=klij"),
        data=ELASTIC_DATA, formula="ijkl=jikl=klij", create=jax_create_scalar, per_atom=False,
    ),
    "nmr": dict(
        model=dict(TINY, num_layers=2, species_embedding_dim=8, invariant_layers=2, invariant_neurons=8,
                   conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+1x2o+1x2e", output_formula="ij=ji",
                   average_num_neighbors="auto"),
        data=NMR_DATA, formula="ij=ji", create=jax_create_atomic, per_atom=True,
    ),
    # tests/test_scripts.py's multi-task setup: a k_voigt head beside the
    # tensor, its target standardized; both predict()s serve the tensor
    "multitask": dict(
        model=dict(TINY, num_layers=2, species_embedding_dim=8, invariant_layers=2, invariant_neurons=8,
                   conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+1x2o+1x2e",
                   conv_to_output_hidden_irreps_out="4x0e+2x2e+4e", output_formula="ijkl=jikl=klij",
                   task_weights={"elastic_tensor_full": 1.0, "k_voigt": 0.5}),
        data=dict(ELASTIC_DATA, scalar_target_names=["k_voigt"], normalize_scalar_targets=[True]),
        formula="ijkl=jikl=klij", create=jax_create_scalar, per_atom=False,
    ),
}


def _fill(tree, seed):
    rng = np.random.default_rng(seed)

    def one(path, s):
        if "running_var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, tree)


@pytest.fixture(scope="module", params=list(FAMILIES))
def served(request, tmp_path_factory):
    """A JAX checkpoint directory of seeded weights with a target
    normalizer, its conversion into a port directory, and predictions of
    both on the same structures (a lone atom among them)."""
    fam = FAMILIES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    rng = np.random.default_rng(11)
    target = fam["data"]["tensor_target_name"]
    scalars = fam["data"].get("scalar_target_names", [])
    dim = jax_cartesian_map(fam["formula"]).irreps.dim
    graphs = []
    for _ in range(2):
        s = _structure(rng, k=3)
        g = JaxGraph.from_structure(s, r_cut=5.0)
        if fam["per_atom"]:
            g.y[target] = rng.normal(size=(len(s), dim))
            g.y["atom_selector"] = np.asarray(s.atomic_numbers) == 14
        else:
            g.y[target] = rng.normal(size=(1, dim))
        for name in scalars:
            g.y[name] = rng.normal(size=(1, 1))
        graphs.append(g)
    batch = jax_collate(graphs, jax_pad_spec(graphs), species_map=jax_species_map(SPECIES))
    ds_hp = dict(allowed_species=list(SPECIES), average_num_neighbors=18.5,
                 global_feats_size=None, atom_feats_size=None)
    # the model as the JAX script builds it: scalar heads from the data section
    heads = dict(tensor_target_name=target, scalar_target_names=scalars) if scalars else {}
    trainer = JaxTrainer(fam["create"](dict(fam["model"], **heads), ds_hp),
                         [JaxTask(name=n, per_atom=fam["per_atom"]) for n in [target] + scalars],
                         JaxConfig(lr=0.01))
    state = trainer.init_state(batch)
    state = state.replace(params=_fill(state.params, 1), batch_stats=_fill(state.batch_stats, 2))
    normalizer = JaxNormalize(jax_cartesian_map(fam["formula"]).irreps, mean=rng.normal(size=dim),
                              norm=rng.uniform(0.5, 2.0, dim))
    stats = jdataset.DatasetStatistics(
        allowed_species=SPECIES, average_num_neighbors=18.5, target_normalizer=normalizer,
        scalar_normalizers={n: JaxScalarNormalize(1, mean=rng.normal(size=1), std=rng.uniform(0.5, 2.0, 1))
                            for n in scalars})
    jax_dir = root / "jax"
    jax_save_sidecar(jax_dir, {"model": fam["model"], "data": fam["data"], "dataset_hparams": ds_hp,
                               "normalize_tensor_target": True}, stats.to_arrays())
    JaxCheckpointManager(jax_dir).save(0, state, {"val/score": 1.0})

    # the conversion, as on a machine that has orbax
    restored = ocp.PyTreeCheckpointer().restore((jax_dir / "epoch_0").absolute())
    variables = {"params": restored["params"], "batch_stats": restored["batch_stats"]}
    hparams, arrays = jax_load_sidecar(jax_dir)
    port_dir = convert_checkpoint(variables, hparams, arrays, root / "port")

    rng = np.random.default_rng(12)
    lone = JaxStructure(lattice=np.eye(3) * 20.0, frac_coords=[[0, 0, 0]], atomic_numbers=[14])
    structures = [_structure(rng, k=4).to_dict(), lone.to_dict(), _structure(rng, k=5).to_dict()]
    return dict(fam=fam, port_dir=port_dir, structures=structures,
                ref=jax_predict(structures, jax_dir), got=predict(structures, port_dir, device="cpu"))


def test_converted_checkpoint_predicts_as_jax(served):
    ref, got = served["ref"], served["got"]
    assert len(got) == len(ref) == 3 and got[1] is None and ref[1] is None
    for i in (0, 2):
        n = len(served["structures"][i]["sites"])
        shape = (n, 3, 3) if served["fam"]["per_atom"] else (3, 3, 3, 3)
        assert got[i].shape == np.asarray(ref[i]).shape == shape and np.isfinite(got[i]).all()
        np.testing.assert_allclose(got[i], np.asarray(ref[i]), **MODEL_TOL)
        if served["fam"]["per_atom"]:
            np.testing.assert_allclose(got[i], got[i].transpose(0, 2, 1), atol=1e-6)
    assert sorted(p.name for p in served["port_dir"].iterdir()) == [
        "dataset_statistics.npz", "hparams.json", "last"]


def test_disk_predict_equals_in_memory_predict(served):
    model, cfg, stats, normalize = load_pretrained(served["port_dir"], device="cpu")
    assert normalize and cfg.per_atom == served["fam"]["per_atom"] and cfg.r_cut == 5.0
    mem = predict(served["structures"], model, stats.target_normalizer)
    for a, b in zip(mem, served["got"]):
        assert (a is None and b is None) or np.array_equal(a, b)


def test_disk_predict_refuses_unsupported_species_and_overrides(served):
    bad = JaxStructure(np.eye(3) * 4, [[0, 0, 0], [0.5, 0.5, 0.5]], [79, 79]).to_dict()
    with pytest.raises(ValueError, match="not trained"):
        predict(bad, served["port_dir"], device="cpu")
    with pytest.raises(ValueError, match="its own"):
        predict(served["structures"], served["port_dir"], r_cut=4.0, device="cpu")


def test_predict_refuses_a_feature_model_where_the_jax_predict_fails(tmp_path):
    """`predict(structures, directory)` builds graphs from structures alone,
    so a model that reads atom or global feature columns cannot be served
    that way: the JAX `predict` fails on such a directory for want of the
    features, and the port's refuses it with a message."""
    rng = np.random.default_rng(13)
    model_hp = dict(TINY, use_atom_feats=True, use_global_feats=True)
    ds_hp = dict(TINY_DS, atom_feats_size=2, global_feats_size=1)
    graphs = [JaxGraph.from_structure(_structure(rng, k=3), r_cut=5.0,
                                      x={"atom_feats": rng.normal(size=(3, 2)), "global_feats": rng.normal(size=(1, 1))},
                                      y={"elastic_tensor_full": rng.normal(size=(1, 21))}) for _ in range(2)]
    batch = jax_collate(graphs, jax_pad_spec(graphs), species_map=jax_species_map(SPECIES))
    trainer = JaxTrainer(jax_create_scalar(model_hp, ds_hp), [JaxTask(name="elastic_tensor_full")],
                         JaxConfig(lr=0.01))
    state = trainer.init_state(batch)
    jax_dir = tmp_path / "jax"
    jax_save_sidecar(jax_dir, {"model": model_hp, "data": dict(ELASTIC_DATA, atom_featurizer="site_feats",
                                                               global_featurizer="density"),
                               "dataset_hparams": ds_hp, "normalize_tensor_target": False},
                     jdataset.DatasetStatistics(allowed_species=SPECIES).to_arrays())
    JaxCheckpointManager(jax_dir).save(0, state, {"val/score": 1.0})
    structures = [_structure(rng, k=3).to_dict()]
    with pytest.raises(KeyError, match="atom_feats"):
        jax_predict(structures, jax_dir)

    restored = ocp.PyTreeCheckpointer().restore((jax_dir / "epoch_0").absolute())
    hparams, arrays = jax_load_sidecar(jax_dir)
    port_dir = convert_checkpoint({"params": restored["params"], "batch_stats": restored["batch_stats"]},
                                  hparams, arrays, tmp_path / "port")
    with pytest.raises(ValueError, match="feature columns"):
        predict(structures, port_dir, device="cpu")
