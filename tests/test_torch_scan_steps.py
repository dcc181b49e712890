"""`TrainerConfig.scan_steps` and the host side of the graphed steps, on
the CPU.

Parity: the port's `fit` with `scan_steps=2` against the JAX `Trainer.fit`
with `scan_steps=2` (its `lax.scan` dispatch of each full group), on the
same pandas-written files through both data modules (2 pad buckets, so
groups are cut by shape changes), from the same converted initial weights,
with SGD and with Adam: every epoch's train loss and val score within 1e-5
relative. On the CPU the port's steps run eagerly; the grouping, the
stacked copies and the host index check are the card's.

Then the grouping alone (a shape change flushes a group, remainders go one
at a time, the losses come back in batch order), the index check on a bad
numpy batch before any copy, the static K1 item bound against the real
count on skewed degrees, and a checkpoint written by a capturable
optimizer restored into a CPU trainer.
"""

import copy

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
from matten_tpu_torch.data import keys as K
from matten_tpu_torch.data.datamodule import TensorDataModule
from matten_tpu_torch.kernels import fused_conv
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig
from matten_tpu_torch.train.graphs import batch_key

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
RTOL = 1e-5
SCAN = 2


def _write(path, n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = int(rng.integers(2, 6))
        s = JaxStructure(np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2, rng.uniform(0, 1, size=(k, 3)),
                         rng.choice(SPECIES, size=k))
        t = rng.normal(size=(3, 3, 3, 3))
        t = (t + t.transpose(1, 0, 2, 3)) / 2
        t = (t + t.transpose(0, 1, 3, 2)) / 2
        rows.append({"structure": s.to_dict(), TARGET: (((t + t.transpose(2, 3, 0, 1)) / 2) * 30.0).tolist()})
    pd.DataFrame(rows).to_json(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan")
    _write(root / "train.json", 10, 1)
    _write(root / "val.json", 6, 2)
    return dict(root=str(root), r_cut=5.0, reuse=False, normalize_tensor_target=True,
                trainset_filename="train.json", valset_filename="val.json", testset_filename="val.json",
                loader_kwargs=dict(batch_size=2, num_buckets=2, node_chunk=None))


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.5), ("adam", 0.002)])
def test_fit_with_scan_steps_matches_jax_per_epoch(files, optimizer, lr):
    """3 epochs of each fit with scan_steps=2: the same groups (full pairs
    through JAX's scan, the rest one step at a time), the same trajectory."""
    cfg = dict(max_epochs=3, lr=lr, optimizer=optimizer, scan_steps=SCAN)
    jdm, pdm = JaxDataModule(**files, seed=4), TensorDataModule(**files, seed=4)
    jdm.setup()
    pdm.setup()
    jt = JaxTrainer(jax_create_model(HPARAMS, jdm.get_to_model_info()), [JaxTask(name=TARGET)], JaxConfig(**cfg))
    state = jt.init_state(next(iter(jdm.train_dataloader())), rng_seed=0)
    model = create_scalar_tensor_model(HPARAMS, pdm.get_to_model_info(), device="cpu")
    model.load_state_dict(flax_to_state_dict({"params": state.params, "batch_stats": state.batch_stats}, model))
    pt = Trainer(model, [CanonicalRegressionTask(name=TARGET)], TrainerConfig(**cfg), device="cpu")
    # the loader gives groups of both kinds: full pairs and remainders
    sizes = [len(g) for g in pt._groups(pdm.train_dataloader())]
    assert SCAN in sizes and 1 in sizes, sizes
    jt.fit(state, jdm)
    ph = pt.fit(pdm)
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jt.history] == [0, 1, 2]
    for j, p in zip(jt.history, ph):
        for key in ("train/loss", "val/loss", "val/score"):
            np.testing.assert_allclose(p[key], j[key], rtol=RTOL, err_msg=f"epoch {p['epoch']} {key}")


# ---------------------------------------------------------------- grouping


def _batch(i, n_nodes, n_edges):
    """A numpy batch of `n_nodes` nodes and `n_edges` edges whose "id"
    field is i."""
    dst = np.sort(np.arange(n_edges) % n_nodes).astype(np.int32)
    data = {K.EDGE_INDEX: np.stack([(dst + 1) % n_nodes, dst]).astype(np.int32),
            K.NODE_MASK: np.ones(n_nodes, bool), K.EDGE_MASK: np.ones(n_edges, bool),
            "id": np.array([i], np.float32)}
    return data, {TARGET: np.full((1, 21), float(i), np.float32)}


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


class _DataModule:
    def __init__(self, shapes):
        self.batches = [_batch(i, *s) for i, s in enumerate(shapes)]

    def train_dataloader(self):
        return _Loader(self.batches)

    def val_dataloader(self):
        return _Loader(self.batches[:1])


# shapes A A A B A A A A C: groups of 3 at most
SHAPES = [(4, 8)] * 3 + [(6, 12)] + [(4, 8)] * 4 + [(5, 10)]


def test_groups_flush_on_shape_change_and_keep_batch_order():
    """Consecutive batches of one key, scan_steps at most; a shape change
    flushes the group; remainders run alone; the fit's steps see the
    batches in loader order and the epoch loss is the mean of every step's
    loss, each from its own batch."""
    dm = _DataModule(SHAPES)
    t = Trainer(torch.nn.Linear(1, 1), [CanonicalRegressionTask(name=TARGET)],
                TrainerConfig(max_epochs=1, scan_steps=3, scheduler="none"), device="cpu")
    groups = [[int(d["id"][0]) for d, _ in g] for g in t._groups(dm.train_dataloader())]
    assert groups == [[0, 1, 2], [3], [4, 5, 6], [7], [8]]
    assert [len({batch_key(*dm.batches[i]) for i in g}) for g in groups] == [1] * 5

    seen, copies = [], []
    group_copy = t._device_group

    def device_group(group):
        copies.append(len(group))
        return group_copy(group)

    def step(data, targets):
        i = float(data["id"][0])
        seen.append(i)
        # the device batch is the host batch's copy, field by field
        assert torch.equal(targets[TARGET], torch.full((1, 21), i))
        return torch.tensor(i), {TARGET: (torch.tensor(0.0), torch.tensor(1.0))}

    t._device_group, t.train_step, t.eval_step = device_group, step, step
    history = t.fit(dm)
    assert seen[:len(SHAPES)] == list(range(len(SHAPES)))
    assert copies[:5] == [3, 1, 3, 1, 1]
    assert history[0]["train/loss"] == pytest.approx(np.mean(range(len(SHAPES))))
    t.config.scan_steps = 1
    assert [len(g) for g in t._groups(dm.train_dataloader())] == [1] * len(SHAPES)


@pytest.mark.parametrize("bad", ["dst order", "dst range", "src range", "src negative"])
def test_index_check_raises_on_the_host_batch_before_any_copy(bad, monkeypatch):
    """A group with one bad batch raises edge_plan's error from the numpy
    check, and nothing of the group is copied."""
    data, targets = _batch(1, 4, 8)
    ei = data[K.EDGE_INDEX].copy()
    if bad == "dst order":
        ei[1] = ei[1][::-1]
    elif bad == "dst range":
        ei[1, -1] = 4
    elif bad == "src range":
        ei[0, 3] = 4
    else:
        ei[0, 0] = -1
    t = Trainer(torch.nn.Linear(1, 1), [CanonicalRegressionTask(name=TARGET)], TrainerConfig(), device="cpu")
    copies = []
    monkeypatch.setattr(torch, "from_numpy", lambda a: copies.append(a) or torch.as_tensor(a))
    with pytest.raises(ValueError, match="non-decreasing"):
        t._device_group([_batch(0, 4, 8), (dict(data, **{K.EDGE_INDEX: ei}), targets)])
    assert copies == []
    with pytest.raises(ValueError, match="non-decreasing"):
        fused_conv.check_edges(ei[0], ei[1], 4, 4)
    fused_conv.check_edges(*_batch(0, 4, 8)[0][K.EDGE_INDEX], 4, 4)
    assert len(t._device_group([_batch(0, 4, 8)])) == 1 and len(copies) == 5


# ---------------------------------------------------------------- item bound


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("te", [16, 8, 4])
def test_static_item_bound_is_never_below_the_count(seed, te):
    """Skewed degrees (a Zipf tail, empty destinations, one hub): K1's grid
    bound at items of te edges is at least cumsum(ceil(deg / te))[-1], the
    count item_ptr holds, and at most the edge count."""
    rng = np.random.default_rng(seed)
    n_out = int(rng.integers(1, 300))
    deg = np.minimum(rng.zipf(1.6, n_out), 4000)
    deg[rng.random(n_out) < 0.3] = 0
    deg[rng.integers(n_out)] += int(rng.integers(0, 3000))
    dst = torch.as_tensor(np.repeat(np.arange(n_out), deg).astype(np.int32))
    src = torch.as_tensor(rng.integers(0, 7, len(dst)).astype(np.int32))
    item_ptr, bound = fused_conv.edge_plan(src, dst, 7, n_out, item_edges=(te,)).items(te)
    count = int(np.cumsum(-(-deg // te))[-1])
    assert int(item_ptr[-1]) == count
    assert count <= bound == fused_conv.item_bound(len(dst), n_out, te) <= len(dst)
    assert fused_conv.item_bound(0, n_out, te) == 0


# ---------------------------------------------------------------- restore


def test_a_capturable_checkpoint_restores_into_a_cpu_trainer():
    """A state written by a trainer whose Adam is capturable (the card's
    graphed trainer) loads into a CPU trainer, which keeps its own choice
    and steps on as the writer does."""
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    x = torch.randn(5, 3)

    def step(t):
        t.optimizer.zero_grad()
        t.model(x).square().sum().backward()
        t.optimizer.step()

    cfg = TrainerConfig(optimizer="adam", lr=0.1)
    a = Trainer(model, [CanonicalRegressionTask(name=TARGET)], cfg, device="cpu")
    step(a)
    state = copy.deepcopy(a.state_dict())  # as a checkpoint holds it
    state["optimizer"]["param_groups"] = [dict(g, capturable=True) for g in state["optimizer"]["param_groups"]]
    b = Trainer(torch.nn.Linear(3, 2), [CanonicalRegressionTask(name=TARGET)], cfg, device="cpu")
    b.load_state_dict(state)
    assert [g["capturable"] for g in b.optimizer.param_groups] == [False]
    step(a)
    step(b)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
