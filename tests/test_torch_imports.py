"""The torch port runs without JAX and without the JAX package.

The GPU machine has no jax, flax, optax, orbax, pandas, pyyaml, sklearn or
wandb, and the port stands alone: neither its sources nor chip_smoke.py nor profiler_fault.py may
import any of them or anything of `matten_tpu` (it keeps its own copies of
the numpy modules it shares with it; `parallel/` included), except wandb,
which only `utils/wandb_utils.py` imports, inside its functions. The runtime checks run in subprocesses
because this test process has imported jax already (tests/conftest.py): one
in the repo, one with `matten_tpu_torch/` copied alone into an empty
directory. Each serves a model from a checkpoint directory it writes, and
takes a train step of each model family; in the copy alone, the materials
train script's `main` also trains a model from a data file on the CPU, once
plain and once with every model and data option (instance norm, norm
activation, gaussian basis, max pooling, atom and global features, a logged
and standardized scalar target beside the tensor, target scale and
weights), whose directory `load_pretrained` then rebuilds.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "pandas", "yaml", "sklearn", "matten_tpu")
SOURCES = sorted((ROOT / "matten_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "profiler_fault.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _imported_at_top(path: Path):
    """Modules imported outside every function and class body."""
    tree = ast.parse(path.read_text())
    inner = {id(n) for f in ast.walk(tree) if isinstance(f, (ast.FunctionDef, ast.ClassDef))
             for n in ast.walk(f) if n is not f}
    for node in ast.walk(tree):
        if id(node) in inner:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_wandb_is_imported_only_lazily(path):
    """wandb is optional: no module imports it at import time, and only the
    W&B utilities import it at all (inside `wandb_available` and the
    logger)."""
    top = {m for m in _imported_at_top(path) if m.split(".")[0] == "wandb"}
    assert not top, f"{path.name} imports {sorted(top)} at import time"
    if path.name != "wandb_utils.py":
        assert not {m for m in _imported(path) if m.split(".")[0] == "wandb"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(
        m for m in set(_imported(path))
        if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)
    )
    assert not bad, f"{path.name} imports {bad}"


RUN = """
import sys
import tempfile
import numpy as np
import torch
torch.set_num_threads(2)
from matten_tpu_torch.data.dataset import DatasetStatistics
from matten_tpu_torch.data.graph import CrystalGraph, collate_graphs, pad_spec_for
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.models import create_atomic_tensor_model, create_scalar_tensor_model
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.predict import batch_to_device, predict
from matten_tpu_torch.train import (CanonicalRegressionTask, CheckpointManager, Trainer,
                                    TrainerConfig, save_sidecar)
from matten_tpu_torch.data.split import train_val_test_split_dataframe
from matten_tpu_torch.kernels.fused_tp import configure_default_tiers
from matten_tpu_torch.utils import DetectAnomaly, check_finite, timing
from matten_tpu_torch.utils.wandb_utils import WandbLogger, wandb_available
assert configure_default_tiers() == "pallas" and not wandb_available()
parts = train_val_test_split_dataframe([{"id": i, "c": i % 2} for i in range(20)], stratify="c")
assert sorted(r["id"] for p in parts for r in p) == list(range(20))
hp = dict(species_embedding_dim=4, irreps_edge_sh="0e+1o+2e", num_layers=1,
          invariant_layers=1, invariant_neurons=4, average_num_neighbors=30.0,
          conv_layer_irreps="2x0o+2x0e+1x1o+1x1e+1x2e", normalization="batch",
          conv_to_output_hidden_irreps_out="2x0e+2e+4e")
nmr_hp = dict(hp, output_formula="ij=ji")
ds = dict(allowed_species=[14])
model = create_scalar_tensor_model(hp, ds, device="cpu")
si = Structure(lattice=np.array([[0, 2.73, 2.73], [2.73, 0, 2.73], [2.73, 2.73, 0]]),
               frac_coords=[[0, 0, 0], [0.25, 0.25, 0.25]], atomic_numbers=[14, 14])
out = predict(si, model)
assert out.shape == (3, 3, 3, 3) and np.isfinite(out).all()
for name, hps, create, y, data_hp in (
        ("elastic_tensor_full", hp, create_scalar_tensor_model, np.ones((1, 21)), {}),
        ("nmr_tensor", nmr_hp, create_atomic_tensor_model, np.ones((2, 6)),
         dict(tensor_target_formula="ij=ji", atom_selector="atom_selector"))):
    g = CrystalGraph.from_structure(si, r_cut=5.0)
    g.y[name] = y
    if data_hp:
        g.y["atom_selector"] = np.array([True, False])
    data, targets = collate_graphs([g], pad_spec_for([g]), species_map=atomic_number_map([14]))
    trainer = Trainer(create(hps, ds, device="cpu"),
                      [CanonicalRegressionTask(name=name, per_atom=bool(data_hp))],
                      TrainerConfig(), device="cpu")
    loss, _ = trainer.train_step(*batch_to_device(data, "cpu", targets))
    assert torch.isfinite(loss)
    with timing.span("anomaly check", always=True):
        DetectAnomaly("step")({"loss": loss.detach()})
    check_finite({"loss": loss.detach()}, "step")
    assert timing.record().seconds("anomaly check") > 0
    with tempfile.TemporaryDirectory() as d:
        save_sidecar(d, {"model": hps, "data": dict(data_hp, tensor_target_name=name),
                         "dataset_hparams": ds, "normalize_tensor_target": False},
                     DatasetStatistics(allowed_species=(14,)).to_arrays())
        CheckpointManager(d).save_last(trainer.state_dict())
        out = predict([si], d, device="cpu")[0]
        lg = WandbLogger(project="p", save_dir=d)
        lg.log({"loss": float(loss)}, step=0)
        lg.finish()
    assert out.shape == ((2, 3, 3) if data_hp else (3, 3, 3, 3)) and np.isfinite(out).all()
"""

LOADED = """
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "yaml", "sklearn", "matten_tpu",
                 "wandb"))
print("LOADED", loaded)
"""

MAIN = """
import json
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.scripts.train_materials_tensor import main
rng = np.random.default_rng(0)
rows = []
for _ in range(6):
    s = Structure(np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1, rng.uniform(0, 1, (3, 3)),
                  rng.choice([8, 14], 3))
    t = rng.normal(size=(3, 3, 3, 3))
    t = (t + t.transpose(1, 0, 2, 3) + t.transpose(0, 1, 3, 2) + t.transpose(2, 3, 0, 1)) / 4
    rows.append({"structure": s.to_dict(), "elastic_tensor_full": t.tolist()})
with open("tiny.json", "w") as f:
    json.dump(rows, f)
model = dict(species_embedding_dim=4, irreps_edge_sh="0e+1o", num_layers=1, invariant_layers=1,
             invariant_neurons=4, average_num_neighbors="auto", conv_layer_irreps="2x0e+1x1o+1x2e",
             normalization="batch", conv_to_output_hidden_irreps_out="2x0e+2e+4e")
config = {"seed_everything": 7, "model": model,
          "data": {"root": ".", "trainset_filename": "tiny.json", "valset_filename": "tiny.json",
                   "testset_filename": "tiny.json", "r_cut": 5.0, "loader_kwargs": {"batch_size": 3}},
          "trainer": {"max_epochs": 2, "checkpoint_dir": "ckpt"}}
metrics = main(config, device="cpu")
assert np.isfinite(metrics["score"]), metrics
"""

VARIANTS = MAIN.replace(
    'rows.append({"structure": s.to_dict(), "elastic_tensor_full": t.tolist()})',
    'rows.append({"structure": s.to_dict(), "elastic_tensor_full": t.tolist(), "k_voigt": float(rng.uniform(1, 9)),'
    ' "site_feat": rng.normal(size=3).tolist(), "density": float(rng.uniform(1, 5)),'
    ' "source": ["dft", "experiment"][len(rows) % 2]})',
).replace("metrics = main(config, device=\"cpu\")", """\
model.update(normalization="instance", nonlinearity_type="norm", radial_basis_type="gaussian", reduce="max",
             use_atom_feats=True, use_global_feats=True, task_weights={"elastic_tensor_full": 1.0, "k_voigt": 0.5})
config["data"].update(atom_featurizer="site_feat", global_featurizer="density", scalar_target_names=["k_voigt"],
                      log_scalar_targets=[True], normalize_scalar_targets=[True], tensor_target_scale=0.1,
                      tensor_target_weight={"source": {"dft": 1.0, "experiment": 2.0}})
metrics = main(config, device="cpu")
assert np.isfinite(metrics["mae/k_voigt"]), metrics
from matten_tpu_torch.predict import load_pretrained
restored, _, stats, _ = load_pretrained("ckpt", device="cpu")
assert restored.scalar_target_names == ("k_voigt",) and "k_voigt" in stats.scalar_normalizers""")


def _run(cwd: Path, code: str = RUN):
    # one BLAS thread: the suite runs in several workers at once
    env = dict(os.environ, PYTHONPATH=str(cwd), OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code + LOADED], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


PARALLEL = """
import sys
from matten_tpu_torch.parallel.launch import run_ranks
hp = dict(species_embedding_dim=4, irreps_edge_sh="0e+1o+2e", num_layers=1, invariant_layers=1,
          invariant_neurons=4, average_num_neighbors=20.0, conv_layer_irreps="2x0o+2x0e+1x1o+1x1e",
          normalization="batch", conv_to_output_hidden_irreps_out="2x0e+2e+4e")
results = run_ranks("test_torch_parallel_ranks:shard_step_on_cpu", 2, {"hparams": hp}, timeout_s=240)
assert results[0] == results[1] and results[0][0] > 0, results
assert results[0][1] == [], results
"""


def test_parallel_step_runs_copied_alone(tmp_path):
    """A 2-rank node-mode train step on the CPU (gloo, `parallel.launch`)
    with `matten_tpu_torch/` and the torch-only rank bodies alone in an
    empty directory: neither the launching process nor a rank loads JAX,
    pandas, pyyaml, sklearn or `matten_tpu`."""
    shutil.copytree(
        ROOT / "matten_tpu_torch", tmp_path / "matten_tpu_torch",
        ignore=shutil.ignore_patterns("_build", "__pycache__"),
    )
    shutil.copy(ROOT / "tests" / "test_torch_parallel_ranks.py", tmp_path)
    _run(tmp_path, PARALLEL)


def test_port_forward_leaves_jax_unloaded():
    """predict() from memory and from a checkpoint directory, and a train
    step of each model family, in the repo, load none of JAX, pandas,
    pyyaml or `matten_tpu`."""
    _run(ROOT)


def test_port_runs_copied_alone(tmp_path):
    """The same with `matten_tpu_torch/` alone in an empty directory: the
    package needs no other file of the repo (its builds go to its own
    `_build/`, which is not copied)."""
    shutil.copytree(
        ROOT / "matten_tpu_torch", tmp_path / "matten_tpu_torch",
        ignore=shutil.ignore_patterns("_build", "__pycache__"),
    )
    _run(tmp_path)
    assert (tmp_path / "matten_tpu_torch" / "_build").is_dir()


def test_train_script_runs_copied_alone(tmp_path):
    """The materials train script's `main` trains from a data file on the
    CPU with `matten_tpu_torch/` alone in an empty directory, loading none
    of JAX, pandas, pyyaml, sklearn or `matten_tpu`."""
    shutil.copytree(
        ROOT / "matten_tpu_torch", tmp_path / "matten_tpu_torch",
        ignore=shutil.ignore_patterns("_build", "__pycache__"),
    )
    _run(tmp_path, MAIN)
    assert (tmp_path / "ckpt" / "hparams.json").is_file() and (tmp_path / "ckpt" / "last").is_dir()


def test_variant_options_run_copied_alone(tmp_path):
    """The materials train script with every model and data option the
    port took in after its first slices, and `load_pretrained` of the
    directory it wrote, with `matten_tpu_torch/` alone in an empty
    directory: none of JAX, pandas, pyyaml, sklearn or `matten_tpu` is
    loaded."""
    assert "k_voigt" in VARIANTS and 'normalization="instance"' in VARIANTS
    shutil.copytree(
        ROOT / "matten_tpu_torch", tmp_path / "matten_tpu_torch",
        ignore=shutil.ignore_patterns("_build", "__pycache__"),
    )
    _run(tmp_path, VARIANTS)
    assert (tmp_path / "ckpt" / "hparams.json").is_file()
