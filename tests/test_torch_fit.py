"""The port's fit loop against the JAX `Trainer.fit` on the CPU, and the
behaviours of the JAX harness tests, mirrored.

Parity: the same pandas-written files go through both data modules (one
pad bucket, `node_chunk=None`); the JAX model's init is converted into the
port's model (`convert.flax_to_state_dict`); both fit 3 epochs with SGD,
the plateau scheduler halving the lr twice.
Per epoch `train/loss`, `val/loss` and `val/score` agree within 1e-4
relative, and the final parameters and running statistics within
rtol=atol=1e-4 (float32 with another summation order, over 6 steps).

The mirrors of tests/train/test_harness.py run the port alone on a small
in-memory data module: overfitting, the plateau scheduler and early stop,
kill-and-resume equal to the uninterrupted run, restore-best, no scheduler,
AdamW, an empty val loader never best, `save_last` every N epochs.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from matten_tpu.data.datamodule import TensorDataModule as JaxDataModule
from matten_tpu.data.structure import Structure as JaxStructure
from matten_tpu.models import create_scalar_tensor_model as jax_create_model
from matten_tpu.train import CanonicalRegressionTask as JaxTask
from matten_tpu.train import Trainer as JaxTrainer
from matten_tpu.train import TrainerConfig as JaxConfig
from matten_tpu_torch.convert import flax_to_state_dict
from matten_tpu_torch.data.dataset import DatasetStatistics, TensorDatasetConfig
from matten_tpu_torch.data.datamodule import BatchLoader, TensorDataModule
from matten_tpu_torch.data.graph import CrystalGraph
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig

torch.set_num_threads(2)

TARGET = "elastic_tensor_full"
SPECIES = (8, 14)
HPARAMS = dict(
    species_embedding_dim=8,
    irreps_edge_sh="0e+1o+2e",
    num_radial_basis=8,
    radial_basis_start=0.0,
    radial_basis_end=5.0,
    radial_basis_type="bessel",
    num_layers=1,
    invariant_layers=1,
    invariant_neurons=8,
    average_num_neighbors=20.0,
    conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+2x2e",
    nonlinearity_type="gate",
    normalization="batch",
    conv_to_output_hidden_irreps_out="4x0e+2x2e+4e",
    output_format="irreps",
    output_formula="ijkl=jikl=klij",
    reduce="mean",
)
RTOL = 1e-4


def _symmetric_elastic(rng):
    t = rng.normal(size=(3, 3, 3, 3))
    t = (t + t.transpose(1, 0, 2, 3)) / 2
    t = (t + t.transpose(0, 1, 3, 2)) / 2
    return (t + t.transpose(2, 3, 0, 1)) / 2


def _write(path, n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = int(rng.integers(2, 5))
        s = JaxStructure(np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2, rng.uniform(0, 1, size=(k, 3)),
                         rng.choice(SPECIES, size=k))
        rows.append({"structure": s.to_dict(), TARGET: (_symmetric_elastic(rng) * 30.0 + 5.0).tolist()})
    pd.DataFrame(rows).to_json(path)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """3 SGD epochs of the JAX fit and of the port's, from the same files
    and the same (converted) initial weights."""
    root = tmp_path_factory.mktemp("fit")
    _write(root / "train.json", 8, 1)
    _write(root / "val.json", 5, 2)
    data = dict(root=str(root), r_cut=5.0, reuse=False, normalize_tensor_target=True,
                trainset_filename="train.json", valset_filename="val.json", testset_filename="val.json",
                loader_kwargs=dict(batch_size=4, num_buckets=1, node_chunk=None))
    # lr 1.0: the val score stops improving after epoch 0, so the plateau
    # scheduler (patience 0) halves the lr in both loops
    cfg = dict(max_epochs=3, lr=1.0, optimizer="sgd", lr_patience=0)
    jdm, pdm = JaxDataModule(**data, seed=4), TensorDataModule(**data, seed=4)
    jdm.setup()
    pdm.setup()
    info = jdm.get_to_model_info()
    jt = JaxTrainer(jax_create_model(HPARAMS, info), [JaxTask(name=TARGET)], JaxConfig(**cfg))
    state = jt.init_state(next(iter(jdm.train_dataloader())), rng_seed=0)
    model = create_scalar_tensor_model(HPARAMS, pdm.get_to_model_info(), device="cpu")
    model.load_state_dict(flax_to_state_dict({"params": state.params, "batch_stats": state.batch_stats}, model))
    pt = Trainer(model, [CanonicalRegressionTask(name=TARGET)], TrainerConfig(**cfg), device="cpu")
    state = jt.fit(state, jdm)
    history = pt.fit(pdm)
    ref = flax_to_state_dict({"params": state.params, "batch_stats": state.batch_stats}, model)
    return jt.history, history, ref, pt.model.state_dict()


def test_fit_history_matches_jax_per_epoch(parity):
    jh, ph, _, _ = parity
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [0, 1, 2]
    for j, p in zip(jh, ph):
        assert sorted(p) == sorted(j)
        for key in ("train/loss", "val/loss", "val/score", f"val/mae/{TARGET}"):
            np.testing.assert_allclose(p[key], j[key], rtol=RTOL, err_msg=key)
        assert p["lr_scale"] == j["lr_scale"]
    # the plateau scheduler (patience 0) acted on the same scores
    assert [h["lr_scale"] for h in ph] == [h["lr_scale"] for h in jh] == [1.0, 0.5, 0.25]


def test_fit_final_parameters_match_jax(parity):
    _, _, ref, got = parity
    assert set(got) == set(ref)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=RTOL, atol=RTOL, err_msg=k)


# ---------------------------------------------------------------- mirrors


class _DataModule:
    """Synthetic graphs; val and test are the train graphs (as in the JAX
    harness tests)."""

    def __init__(self, seed, n=8):
        rng = np.random.default_rng(seed)
        graphs = []
        for _ in range(n):
            s = Structure(np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2, rng.uniform(0, 1, size=(4, 3)),
                          rng.choice(SPECIES, size=4))
            g = CrystalGraph.from_structure(s, r_cut=5.0)
            g.y[TARGET] = rng.normal(size=(1, 21))
            graphs.append(g)
        self.graphs = graphs
        self.statistics = DatasetStatistics.compute(graphs, TensorDatasetConfig())
        self.species_map = atomic_number_map(self.statistics.allowed_species)

    def _loader(self, shuffle):
        return BatchLoader(self.graphs, batch_size=4, species_map=self.species_map, shuffle=shuffle,
                           edge_multiple=256)

    def train_dataloader(self):
        return self._loader(True)

    def val_dataloader(self):
        return self._loader(False)

    test_dataloader = val_dataloader

    def get_to_model_info(self):
        return {"allowed_species": list(self.statistics.allowed_species),
                "average_num_neighbors": self.statistics.average_num_neighbors}


def _trainer(dm, seed=0, **cfg):
    model = create_scalar_tensor_model(HPARAMS, dm.get_to_model_info(), device="cpu", seed=seed)
    return Trainer(model, [CanonicalRegressionTask(name=TARGET)], TrainerConfig(**cfg), device="cpu")


def test_loss_decreases_and_overfits():
    dm = _DataModule(0)
    history = _trainer(dm, max_epochs=10, lr=0.02).fit(dm)
    losses = [h["train/loss"] for h in history]
    assert losses[-1] < losses[0] * 0.9, losses


def test_plateau_and_early_stop(tmp_path):
    """With lr 0 the val score never improves after epoch 0: the plateau
    scheduler (patience 0) halves the scale every epoch and early stopping
    (patience 1) ends the run at epoch 2, saving `last` there."""
    dm = _DataModule(2)
    t = _trainer(dm, max_epochs=10, lr=0.0, lr_patience=0, early_stopping_patience=1,
                 checkpoint_dir=str(tmp_path / "ck"), save_last_every_epochs=100)
    history = t.fit(dm)
    assert [h["epoch"] for h in history] == [0, 1, 2]
    assert [h["lr_scale"] for h in history] == [1.0, 0.5, 0.25]
    assert all(g["lr"] == 0.0 for g in t.optimizer.param_groups)
    assert json.loads((tmp_path / "ck" / "loop_state.json").read_text())["epoch"] == 2
    assert t.has_best() and t._ckpt_manager.best_epoch == 0


def test_kill_and_resume_reproduces_schedule(tmp_path):
    """A run killed after epoch 2 and resumed from `last` equals the
    uninterrupted run: the same batch order, the same LR schedule, the same
    parameters."""
    dm = _DataModule(5)

    def make(max_epochs, ckpt, seed=0):
        return _trainer(dm, seed=seed, max_epochs=max_epochs, lr=0.02, lr_factor=0.5, lr_patience=1,
                        checkpoint_dir=str(tmp_path / ckpt))

    full = make(6, "full")
    full.fit(dm)
    make(3, "resumed").fit(dm)
    resumed = make(6, "resumed", seed=9)  # other initial weights: all come from `last`
    history = resumed.fit(dm, resume=True)
    assert [h["epoch"] for h in history] == [3, 4, 5]
    tail = [h for h in full.history if h["epoch"] >= 3]
    for a, b in zip(tail, history):
        assert a["lr_scale"] == b["lr_scale"]
        for key in ("train/loss", "val/loss", "val/score"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-6, err_msg=key)
    assert resumed.optimizer.param_groups[0]["lr"] == full.optimizer.param_groups[0]["lr"]
    assert resumed.scheduler == full.scheduler
    ref = full.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


def test_restore_best_gives_best_epoch_metrics(tmp_path):
    """Testing the best checkpoint reproduces the best epoch's val score
    (val and test are the same graphs here)."""
    dm = _DataModule(11)
    t = _trainer(dm, max_epochs=8, lr=0.2, checkpoint_dir=str(tmp_path / "ck"))
    t.fit(dm)
    scores = [h["val/score"] for h in t.history]
    best = int(np.argmin(scores))
    final = t.test(dm)["score"]
    assert t.has_best() and t._ckpt_manager.best_epoch == best
    t.restore_best()
    np.testing.assert_allclose(t.test(dm)["score"], scores[best], rtol=1e-6)
    assert t.test(dm)["score"] <= final + 1e-9


def test_scheduler_none_keeps_lr_constant():
    dm = _DataModule(12)
    t = _trainer(dm, max_epochs=4, lr=0.02, scheduler="none", lr_patience=0)
    assert t.scheduler is None
    t.fit(dm)
    assert all(h["lr_scale"] == 1.0 for h in t.history)
    assert t.optimizer.param_groups[0]["lr"] == 0.02


def test_adamw_optimizer_trains():
    dm = _DataModule(13)
    t = _trainer(dm, max_epochs=4, lr=0.02, optimizer="adamw")
    assert isinstance(t.optimizer, torch.optim.AdamW)
    losses = [h["train/loss"] for h in t.fit(dm)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_empty_val_loader_never_becomes_best(tmp_path):
    dm = _DataModule(21)
    t = _trainer(dm, max_epochs=2, lr=0.01, checkpoint_dir=str(tmp_path / "ck"))
    out = t._run_eval(iter(()))
    assert out["score"] == float("inf") and np.isnan(out["loss"])
    dm.val_dataloader = lambda: iter(())
    t.fit(dm)
    assert not t.has_best()
    assert all(h["val/score"] == float("inf") for h in t.history)


def test_save_last_every_n_epochs(tmp_path):
    """save_last_every_epochs=3: `last` on epochs 2 and 5 and always the
    final epoch; a resume continues from the final one."""
    dm = _DataModule(31)
    kw = dict(lr=0.02, checkpoint_dir=str(tmp_path / "ck"), save_last_every_epochs=3)
    t = _trainer(dm, max_epochs=7, **kw)
    saved = []
    save_last = t._ckpt_manager.save_last
    t._ckpt_manager.save_last = lambda state, loop: (saved.append(loop["epoch"]), save_last(state, loop))
    t.fit(dm)
    assert saved == [2, 5, 6]
    assert json.loads((tmp_path / "ck" / "loop_state.json").read_text())["epoch"] == 6
    history = _trainer(dm, seed=1, max_epochs=9, **kw).fit(dm, resume=True)
    assert [h["epoch"] for h in history] == [7, 8]


def test_eval_between_epochs_leaves_steps_in_train_mode():
    """The val pass runs in eval mode; the next train step is back in train
    mode and moves the batch-norm running statistics."""
    dm = _DataModule(40)
    t = _trainer(dm, max_epochs=1, lr=0.01)
    t.fit(dm)
    assert not t.model.training
    before = {k: v.clone() for k, v in t.model.state_dict().items() if "running" in k}
    from matten_tpu_torch.predict import batch_to_device

    data, targets = next(iter(dm.train_dataloader()))
    t.train_step(*batch_to_device(data, "cpu", targets))
    assert t.model.training
    assert any(not torch.equal(v, t.model.state_dict()[k]) for k, v in before.items())


def test_metrics_logger_gets_each_epoch_record():
    """A `metrics_logger` receives each epoch's history record, with the
    epoch as its step."""
    dm = _DataModule(41)
    logged = []

    class Recorder:
        def log(self, record, step):
            logged.append((step, record))

    model = create_scalar_tensor_model(HPARAMS, dm.get_to_model_info(), device="cpu", seed=0)
    t = Trainer(model, [CanonicalRegressionTask(name=TARGET)], TrainerConfig(max_epochs=3, lr=0.01),
                device="cpu", metrics_logger=Recorder())
    history = t.fit(dm)
    assert [h["epoch"] for h in history] == [0, 1, 2]
    assert logged == [(h["epoch"], h) for h in history]
