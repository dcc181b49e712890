"""The port's config reader, `build_trainer_config` and train scripts
against the JAX package's on the CPU.

- `load_config` equals `yaml.safe_load` on the configs in
  `scripts/configs/` and on strings that exercise YAML 1.1's number rules
  (`0.` is a float, `1e-5` a string) and its nulls and booleans; input
  outside the subset raises.
- `build_trainer_config` and `build_mesh_spec` equal the JAX functions
  field by field; a world size other than the mesh's is refused.
- Both scripts' `main` under `trainer.mesh` (data 1 x graph 2, each mode)
  on 2 gloo ranks of the CPU give the test metrics of the one-device run
  of the same config (1e-5), and the directory the primary rank wrote has
  the one-device run's sidecars and serves `predict`.
- Both scripts' `main(config, device="cpu")` train and test on a tiny
  pandas-written set; their `hparams.json` and `dataset_statistics.npz`
  equal those the JAX scripts write for the same config and data (1e-12),
  and `predict(structures, directory)` serves what they wrote. A rerun with
  `restore: true` adds one epoch; the command line runs as a module. The
  multi-task materials script (a `k_voigt` head, the target options) writes
  the JAX script's sidecars and history keys.
"""

import importlib.util
import json
import math
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from matten_tpu.data.structure import Structure as JaxStructure
from matten_tpu.train import Trainer as JaxTrainer
from matten_tpu.train.config import build_mesh_spec as jax_build_mesh_spec
from matten_tpu.train.config import build_trainer_config as jax_build_trainer_config
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.parallel.launch import run_ranks
from matten_tpu_torch.predict import predict
from matten_tpu_torch.scripts import train_atomic_tensor, train_materials_tensor
from matten_tpu_torch.train import Trainer
from matten_tpu_torch.train.config import build_mesh_spec, build_trainer_config
from matten_tpu_torch.utils.config_yaml import load_config, loads

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "scripts" / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_equals_safe_load(path):
    assert load_config(path) == yaml.safe_load(path.read_text())


NUMBERS = """\
a: 0.
b: 0.00001
c: 1e-5
d: 1.0e-5
e: 1.0e5
f: null
g: ~
h:
i: true
j: Off
k: yes
l: 0x1F
m: 017
n: 08
o: 1_000
p: -.inf
q: .nan
r: +5
s: -0.5
t: .5
u: '0.'
v: "1e-5"
x: []
y: {}
z: 3. # a comment
"""


def test_load_config_number_rules():
    ours, ref = loads(NUMBERS), yaml.safe_load(NUMBERS)
    assert list(ours) == list(ref)
    for k in ref:
        assert type(ours[k]) is type(ref[k]), k
        if isinstance(ref[k], float) and math.isnan(ref[k]):
            assert math.isnan(ours[k])
        else:
            assert ours[k] == ref[k], k
    assert ours["a"] == 0.0 and isinstance(ours["a"], float)
    assert ours["c"] == "1e-5" and ours["b"] == 1e-5 and ours["f"] is None


def test_load_config_lists_and_nesting():
    text = ("top:\n- a: 1\n  b:\n    - x\n    - 'y # z'\n- c\n-\n  d: 2\nk: v # c\n"
            "n:\n  - 1\n  -   e: f\n      g: h\n")
    assert loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &x 1\n", "a: *x\n", "a: !!str 1\n", "a: |\n  t\n", "a: >\n  t\n", "a: [1, 2]\n",
    "a: {b: 1}\n", "a: b\n  c\n", "---\na: 1\n", "a: 2001-12-14\n", "a:\n\tb: 1\n", "a: b: c\n",
    "<<: 1\n", "a: 'open\n", "a: 1:20\n", 'a: "\\x41"\n',
], ids=["anchor", "alias", "tag", "literal", "folded", "flow_list", "flow_map", "multiline",
        "document", "timestamp", "tab", "nested_colon", "merge", "open_quote", "base60", "escape"])
def test_load_config_refuses_outside_the_subset(text):
    with pytest.raises(ValueError, match="outside the YAML subset"):
        loads(text)


def _trainer_cases():
    base = {"trainer": {"max_epochs": 1}}
    cases = [load_config(p) for p in CONFIGS] + [base]
    for cp in ("torch.optim.Adam", "torch.optim.AdamW", "torch.optim.SGD", "optax.adam"):
        cases.append(dict(base, optimizer={"class_path": cp, "init_args": {"lr": 0.02}}))
    for cp in ("torch.optim.lr_scheduler.ReduceLROnPlateau", "none"):
        cases.append(dict(base, lr_scheduler={"class_path": cp}))
    cases.append(dict(base, trainer={"callbacks": [
        {"class_path": "ModelCheckpoint", "init_args": {"save_top_k": 5}},
        {"class_path": "EarlyStopping", "init_args": {"patience": 7}}], "save_last_every_epochs": 4}))
    return cases


@pytest.mark.parametrize("config", _trainer_cases())
def test_build_trainer_config_matches_jax(config):
    ours, ref = build_trainer_config(config), jax_build_trainer_config(config)
    fields = vars(ours)
    assert set(fields) == set(vars(ref))
    for k, v in fields.items():
        assert v == getattr(ref, k), k


def test_build_trainer_config_refuses_unknown_classes():
    base = {"trainer": {"max_epochs": 1}}
    with pytest.raises(ValueError, match="optimizer.class_path"):
        build_trainer_config(dict(base, optimizer={"class_path": "torch.optim.LBFGS"}))
    with pytest.raises(ValueError, match="lr_scheduler.class_path"):
        build_trainer_config(dict(base, lr_scheduler={"class_path": "torch.optim.lr_scheduler.StepLR"}))


MESH_CASES = [{}, {"devices": 1}, {"devices": 4}, {"mesh": {"data": 2, "graph": 2, "mode": "node"}},
              {"mesh": {"data": 1, "graph": 2}}, {"mesh": {"graph": 4, "mode": "node_ring"}, "devices": 4},
              {"mesh": {"data": 1, "graph": 1}}, {"devices": None}]


@pytest.mark.parametrize("trainer", MESH_CASES)
def test_build_mesh_spec_matches_jax(trainer):
    ours, ref = build_mesh_spec({"trainer": trainer}), jax_build_mesh_spec({"trainer": trainer})
    assert (ours is None) == (ref is None)
    if ref is not None:
        assert vars(ours) == vars(ref)
        assert (ours.n_devices, ours.is_multichip) == (ref.n_devices, ref.is_multichip)
        assert ours.loader_kwargs() == ref.loader_kwargs()
    for bad, match in (({"devices": 8, "mesh": {"data": 2, "graph": 2}}, "inconsistent"),
                       ({"mesh": {"data": 2, "graph": 2, "mode": "ring"}}, "mode")):
        for fn in (build_mesh_spec, jax_build_mesh_spec):
            with pytest.raises(ValueError, match=match):
                fn({"trainer": bad})


def test_multi_device_configs_raise():
    """A multi-device config is a `MeshSpec`; its script refuses a world of
    another size (here one process without a process group)."""
    assert build_mesh_spec({"trainer": {}}) is None
    assert build_mesh_spec({"trainer": {"devices": 1}}) is None
    assert vars(build_mesh_spec({"trainer": {"devices": 4}})) == dict(n_data=4, n_graph=1, mode="edge")
    spec = build_mesh_spec({"trainer": {"mesh": {"data": 2, "graph": 2, "mode": "node"}}})
    assert spec.loader_kwargs() == dict(num_shards=2, num_edge_shards=2, node_shard=True, ring=False)
    config = dict(load_config(ROOT / "scripts" / "configs" / "materials_tensor.yaml"))
    config["trainer"] = dict(config["trainer"], devices=2)
    with pytest.raises(ValueError, match=r"ask for 2 ranks .* the world has 1 process"):
        train_materials_tensor.main(config, device="cpu")


# ---------------------------------------------------------------- scripts


def _symmetric_elastic(rng):
    t = rng.normal(size=(3, 3, 3, 3))
    t = (t + t.transpose(1, 0, 2, 3)) / 2
    t = (t + t.transpose(0, 1, 3, 2)) / 2
    return (t + t.transpose(2, 3, 0, 1)) / 2


def _write_tiny_dataset(path, kind, n=6, seed=0):
    """As tests/test_scripts.py writes it: pandas' default layout."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        z = rng.choice([8, 14], 3)
        z[0] = 14
        s = JaxStructure(np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1, rng.uniform(0, 1, (3, 3)), z)
        row = {"structure": s.to_dict()}
        if kind == "materials":
            row["elastic_tensor_full"] = (_symmetric_elastic(rng) * 20.0).tolist()
        else:
            t = rng.normal(size=(int((z == 14).sum()), 3, 3)) * 10.0 + 100.0
            row["nmr_tensor"] = ((t + t.transpose(0, 2, 1)) / 2).tolist()
            row["atom_selector"] = (z == 14).tolist()
        rows.append(row)
    pd.DataFrame(rows).to_json(path)


MODEL = {
    "species_embedding_dim": 8,
    "irreps_edge_sh": "0e + 1o + 2e",
    "radial_basis_type": "bessel",
    "num_radial_basis": 4,
    "radial_basis_start": 0.0,
    "radial_basis_end": 5.0,
    "num_layers": 1,
    "invariant_layers": 1,
    "invariant_neurons": 8,
    "average_num_neighbors": "auto",
    "conv_layer_irreps": "4x0e+2x1o+2x2e",
    "nonlinearity_type": "gate",
    "normalization": "batch",
}
FAMILIES = {
    "materials": dict(
        model=dict(MODEL, conv_to_output_hidden_irreps_out="4x0e + 2x2e + 4e", output_format="irreps",
                   output_formula="ijkl=jikl=klij", reduce="mean"),
        data=dict(tensor_target_name="elastic_tensor_full"),
        shape=lambda s: (3, 3, 3, 3)),
    "atomic": dict(
        model=dict(MODEL, output_format="irreps", output_formula="ij=ji"),
        data=dict(tensor_target_name="nmr_tensor", tensor_target_formula="ij=ji", atom_selector="atom_selector"),
        shape=lambda s: (len(s), 3, 3)),
}


def _config(tmp_path, kind, ckpt):
    return {
        "seed_everything": 7,
        "data": dict(FAMILIES[kind]["data"], root=str(tmp_path), trainset_filename="tiny.json",
                     valset_filename="tiny.json", testset_filename="tiny.json", r_cut=5.0, reuse=False,
                     normalize_tensor_target=True, loader_kwargs={"batch_size": 3, "shuffle": True}),
        "model": FAMILIES[kind]["model"],
        "trainer": {"max_epochs": 2, "checkpoint_dir": str(tmp_path / ckpt)},
        "optimizer": {"class_path": "torch.optim.Adam", "init_args": {"lr": 0.01, "weight_decay": 1e-5}},
        "lr_scheduler": {"init_args": {"factor": 0.5, "patience": 50}},
    }


def _jax_script(kind):
    path = ROOT / "scripts" / f"train_{kind}_tensor.py"
    spec = importlib.util.spec_from_file_location(f"jax_train_{kind}_tensor", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_script_matches_jax_sidecars_and_serves(tmp_path, monkeypatch, kind):
    _write_tiny_dataset(tmp_path / "tiny.json", kind)
    script = {"materials": train_materials_tensor, "atomic": train_atomic_tensor}[kind]
    metrics = script.main(_config(tmp_path, kind, "port"), device="cpu")
    assert np.isfinite(metrics["score"]) and np.isfinite(metrics["loss"])
    port = tmp_path / "port"
    assert {"hparams.json", "dataset_statistics.npz", "index.json", "last", "loop_state.json"} <= {
        p.name for p in port.iterdir()}

    # the JAX script writes its sidecars before fit: its fit and test are
    # not needed for them and are skipped here
    monkeypatch.chdir(tmp_path)  # its logger writes matten_tpu.log to the working directory
    monkeypatch.setattr(JaxTrainer, "fit", lambda self, state, dm, **kw: state)
    monkeypatch.setattr(JaxTrainer, "test", lambda self, state, dm: {})
    _jax_script(kind).main(_config(tmp_path, kind, "jax"))
    jax_dir = tmp_path / "jax"
    assert json.loads((port / "hparams.json").read_text()) == json.loads((jax_dir / "hparams.json").read_text())
    ours, ref = dict(np.load(port / "dataset_statistics.npz")), dict(np.load(jax_dir / "dataset_statistics.npz"))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-12, atol=1e-12, err_msg=k)

    rng = np.random.default_rng(3)
    structures = [Structure(np.eye(3) * 4.0, rng.uniform(0, 1, (k, 3)), [14] + [8] * (k - 1)) for k in (2, 3)]
    results = predict(structures, port, device="cpu")
    for s, r in zip(structures, results):
        assert r.shape == FAMILIES[kind]["shape"](s) and np.isfinite(r).all()


def test_restore_adds_one_epoch(tmp_path):
    _write_tiny_dataset(tmp_path / "tiny.json", "materials")
    config = _config(tmp_path, "materials", "ckpt")
    train_materials_tensor.main(config, device="cpu")
    loop = json.loads((tmp_path / "ckpt" / "loop_state.json").read_text())
    assert loop["epoch"] == 1
    config = dict(config, restore=True, trainer=dict(config["trainer"], max_epochs=3))
    train_materials_tensor.main(config, device="cpu")
    assert json.loads((tmp_path / "ckpt" / "loop_state.json").read_text())["epoch"] == 2


def test_command_line_runs_the_script(tmp_path):
    """`python -m matten_tpu_torch.scripts.train_atomic_tensor config.yaml
    --device cpu` reads a YAML file pyyaml wrote."""
    _write_tiny_dataset(tmp_path / "tiny.json", "atomic")
    config = _config(tmp_path, "atomic", "ckpt")
    config["trainer"]["max_epochs"] = 1
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config, default_flow_style=False))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "matten_tpu_torch.scripts.train_atomic_tensor", str(tmp_path / "config.yaml"),
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "test metrics (best checkpoint)" in proc.stderr
    assert (tmp_path / "ckpt" / "last").is_dir()


def test_torchrun_launches_the_script_on_a_mesh(tmp_path):
    """The documented launch of a mesh run, `torchrun --nproc-per-node 2 -m
    matten_tpu_torch.scripts.train_materials_tensor config.yaml` (here with
    `--device cpu`, so gloo): the ranks join from torchrun's environment
    (and its OMP_NUM_THREADS=1), train on a data 1 x graph 2 node mesh, and
    the primary rank's directory serves a one-device model. The world runs
    in a session of its own, killed whole if it outlives its time limit."""
    _write_tiny_dataset(tmp_path / "tiny.json", "materials")
    config = _config(tmp_path, "materials", "ckpt")
    config["trainer"].update(max_epochs=1, devices=2, mesh={"data": 1, "graph": 2, "mode": "node"})
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config, default_flow_style=False))
    env = {k: v for k, v in os.environ.items() if k not in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", "-m",
         "matten_tpu_torch.scripts.train_materials_tensor", str(tmp_path / "config.yaml"), "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err
    assert "mesh: data=1 graph=2 mode=node" in err and "test metrics (best checkpoint)" in err
    structures = [Structure(np.eye(3) * 4.0, np.random.default_rng(3).uniform(0, 1, (3, 3)), [14, 8, 8])]
    out = predict(structures, tmp_path / "ckpt", device="cpu")[0]
    assert out.shape == (3, 3, 3, 3) and np.isfinite(out).all()


def test_multitask_script_matches_jax(tmp_path, monkeypatch):
    """The materials script with tests/test_scripts.py's multi-task setup
    (a `k_voigt` head beside the tensor, weighted 0.5) and the dataset's
    target options (the scalar logged and standardized, the tensor scaled,
    weights picked by a string column): the sidecars equal the JAX
    script's, both fits record the same history keys and return the same
    test metric keys, the score aggregates the MAEs by the task weights, and
    `predict(structures, directory)` serves the tensor."""
    rng = np.random.default_rng(3)
    rows = []
    for i in range(6):
        s = JaxStructure(np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1, rng.uniform(0, 1, (3, 3)),
                         [14] + list(rng.choice([8, 14], 2)))
        t = _symmetric_elastic(rng) * 20.0
        rows.append({"structure": s.to_dict(), "elastic_tensor_full": t.tolist(),
                     "k_voigt": [float(abs(np.einsum("iijj", t)) / 9 + 1.0)], "source": ["dft", "exp"][i % 2]})
    pd.DataFrame(rows).to_json(tmp_path / "tiny.json")

    def config(ckpt):
        c = _config(tmp_path, "materials", ckpt)
        c["data"].update(scalar_target_names=["k_voigt"], log_scalar_targets=[True],
                         normalize_scalar_targets=[True], tensor_target_scale=0.1,
                         tensor_target_weight={"source": {"dft": 1.0, "exp": 2.0}})
        c["model"] = dict(c["model"], task_weights={"elastic_tensor_full": 1.0, "k_voigt": 0.5})
        return c

    made = {}
    for name, cls in (("port", Trainer), ("jax", JaxTrainer)):
        fit = cls.fit

        def recording(self, *args, _fit=fit, _name=name, **kwargs):
            made[_name] = self
            return _fit(self, *args, **kwargs)

        monkeypatch.setattr(cls, "fit", recording)
    metrics = train_materials_tensor.main(config("port"), device="cpu")
    monkeypatch.chdir(tmp_path)  # the JAX script's logger writes matten_tpu.log to the working directory
    ref = _jax_script("materials").main(config("jax"))

    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert json.loads((port / "hparams.json").read_text()) == json.loads((jax_dir / "hparams.json").read_text())
    ours, want = dict(np.load(port / "dataset_statistics.npz")), dict(np.load(jax_dir / "dataset_statistics.npz"))
    assert sorted(ours) == sorted(want) and "scalar_k_voigt_std" in ours
    for k in want:
        np.testing.assert_allclose(ours[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)
    assert [sorted(h) for h in made["port"].history] == [sorted(h) for h in made["jax"].history]
    assert {"val/mae/elastic_tensor_full", "val/mae/k_voigt"} <= set(made["port"].history[-1])
    assert sorted(metrics) == sorted(ref)
    assert all(np.isfinite(v) for v in metrics.values())
    np.testing.assert_allclose(metrics["score"],
                               metrics["mae/elastic_tensor_full"] + 0.5 * metrics["mae/k_voigt"], rtol=1e-6)
    structures = [Structure(np.eye(3) * 4.0, rng.uniform(0, 1, (3, 3)), [14, 8, 8])]
    (result,) = predict(structures, port, device="cpu")
    assert result.shape == (3, 3, 3, 3) and np.isfinite(result).all()


MESH_MODES = ("edge", "node", "node_ring")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Each family's script on a data 1 x graph 2 mesh in each mode (one
    2-rank world runs all six), and on one device: {(kind, mode): (test
    metrics of each rank, directory), kind: (metrics, directory)}."""
    tmp = tmp_path_factory.mktemp("mesh")
    jobs, out = [], {}
    for kind in FAMILIES:
        _write_tiny_dataset(tmp / "tiny.json", kind)
        (tmp / kind).mkdir()
        (tmp / "tiny.json").rename(tmp / kind / "tiny.json")
        config = _config(tmp / kind, kind, "single")
        out[kind] = ({"materials": train_materials_tensor, "atomic": train_atomic_tensor}[kind].main(
            config, device="cpu"), tmp / kind / "single")
        for mode in MESH_MODES:
            config = _config(tmp / kind, kind, f"mesh_{mode}")
            config["trainer"]["mesh"] = {"data": 1, "graph": 2, "mode": mode}
            jobs.append((kind, mode, config))
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)]), "OMP_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}
    ranks = run_ranks("test_torch_parallel_ranks:run_scripts", 2, jobs, timeout_s=240, env=env)
    for kind, mode, config in jobs:
        out[kind, mode] = ([r[kind, mode] for r in ranks], Path(config["trainer"]["checkpoint_dir"]))
    return out


@pytest.mark.parametrize("mode", MESH_MODES)
@pytest.mark.parametrize("kind", list(FAMILIES))
def test_script_on_a_mesh_matches_one_device(mesh_runs, kind, mode):
    (rank0, rank1), directory = mesh_runs[kind, mode]
    single, single_dir = mesh_runs[kind]
    assert rank0 == rank1
    assert sorted(rank0) == sorted(single)
    for k, v in single.items():
        np.testing.assert_allclose(rank0[k], v, rtol=1e-5, err_msg=k)
    # the sidecars of a one-device model: the config's model section,
    # without the graph_parallel_* hparams the run added
    assert json.loads((directory / "hparams.json").read_text()) == json.loads(
        (single_dir / "hparams.json").read_text())
    assert sorted(p.name for p in directory.iterdir()) == sorted(p.name for p in single_dir.iterdir())
    rng = np.random.default_rng(3)
    structures = [Structure(np.eye(3) * 4.0, rng.uniform(0, 1, (k, 3)), [14] + [8] * (k - 1)) for k in (2, 3)]
    for a, b in zip(predict(structures, directory, device="cpu"), predict(structures, single_dir, device="cpu")):
        assert a.shape == b.shape and np.isfinite(a).all()
