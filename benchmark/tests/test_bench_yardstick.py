"""The yardstick on the CPU: the generators repeat by seed, the work counts
match hand counts and do not move with padding or the FCTP form, and the
reference agrees with the port's plain path at a tiny size."""

import json

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.weights import make_weights
from benchmark.work import Work, least_s

from .conftest import DATA

TINY = ("tiny-matten-elasticity-s73", "tiny-matten-nmr-si")


def _load(name):
    return json.loads((DATA / f"{name}.json").read_text())


@pytest.mark.parametrize("name", TINY)
def test_the_draw_repeats_by_seed_and_keeps_its_sizes(name):
    config, mix = _load(name), _load("tiny-train")
    a, b, c = (traffic.draw_rows(mix, config, s) for s in (2**31 + 11, 2**31 + 11, 5))
    assert json.dumps(a) == json.dumps(b) and json.dumps(a) != json.dumps(c)
    for split in a:
        assert len(a[split]) == traffic.set_sizes(mix, config)[split]
        assert sorted(len(r["structure"]["sites"]) for r in a[split]) == sorted(
            len(r["structure"]["sites"]) for r in c[split])


def test_the_weights_repeat_by_seed():
    shapes = [("a.w", (3, 4)), ("b.norm.weight", (5,)), ("b.norm.bias", (5,)), ("c.linear.weight", (2, 9))]
    w1, w2, w3 = (make_weights(shapes, s, torch.device("cpu")) for s in (2**31 + 3, 2**31 + 3, 4))
    assert all(torch.equal(w1[k], w2[k]) for k in w1) and not torch.equal(w1["a.w"], w3["a.w"])
    assert torch.equal(w1["b.norm.weight"], torch.ones(5)) and torch.equal(w1["b.norm.bias"], torch.zeros(5))


def _ref_model(config, species, neighbours=10.0):
    from benchmark.reference.models.tfn import create_atomic_tensor_model, create_scalar_tensor_model

    create = create_atomic_tensor_model if config["family"] == "atomic" else create_scalar_tensor_model
    return create(dict(config["model"]), {"allowed_species": species, "average_num_neighbors": neighbours},
                  device="cpu", seed=0)


def test_uvu_counts_match_a_hand_count():
    from benchmark.reference.ops.irreps import Irreps
    from benchmark.reference.ops.tensor_product import uvu_tp_plan
    from benchmark.work import _uvu_terms

    # 2x1o (x) 0e+1o into 0e+1o+2e: paths 1o x 0e -> 1o (CG nonzeros 3, t
    # pairs 3), 1o x 1o -> 0e (3, 3) and -> 2e (11, 11: the i that meet each
    # k of xy, yz, z2, xz, x2-y2 are 2, 2, 3, 2, 2); 1o x 1o -> 1e is no 1o
    plan = uvu_tp_plan(Irreps("2x1o"), Irreps("0e+1o"), Irreps("0e+1o+2e"))
    c, t, o = _uvu_terms(plan)
    assert c == 3 + 3 + 11
    assert t == 2 * (3 + 3 + 11)
    assert o == 2 * (3 + 1 + 5) == plan.irreps_out.dim


def test_fctp_work_is_one_hot_and_ignores_the_species_count():
    from benchmark.work import ADAM_FLOPS

    config = _load("tiny-matten-elasticity-s73")
    small = Work(_ref_model(config, [8, 13, 14]), config)
    large = Work(_ref_model(config, list(range(3, 76))), config)
    assert small.forward_flops(100, 3000, 8) == large.forward_flops(100, 3000, 8)
    assert small.conv("fwd", 100, 3000) == large.conv("fwd", 100, 3000)
    # only Adam, which updates every species' weights, grows with the species
    extra = large.train_flops(100, 3000, 8) - small.train_flops(100, 3000, 8)
    assert extra == ADAM_FLOPS * (large.params - small.params) > 0


def test_work_reads_real_counts_only_and_no_form(monkeypatch):
    config = _load("tiny-matten-elasticity-s73")
    work = Work(_ref_model(config, [8, 13, 14]), config)
    monkeypatch.setenv("MATTEN_ONEHOT_GATHER_MIN_S", "1")
    gathered = Work(_ref_model(config, [8, 13, 14]), config)
    assert work.train_flops(90, 2000, 7) == gathered.train_flops(90, 2000, 7)
    fwd = work.conv("fwd", 90, 2000)
    layer = work.layers[0]
    assert fwd[0][0] == 4 * (90 * layer["d1"] + 90 * layer["dout"] + 2000 * (layer["d2"] + layer["dw"])) + 8 * 2000
    assert fwd[0][1] == 2000 * layer["fwd_edge"]
    t, by = least_s(*fwd[0])
    assert t > 0 and by in ("bytes", "operations")


@pytest.mark.parametrize("name", TINY)
def test_the_reference_agrees_with_the_port_at_a_tiny_size(name, tmp_path):
    from matten_tpu_torch.data.datamodule import TensorDataModule
    from matten_tpu_torch.models.tfn import create_atomic_tensor_model, create_scalar_tensor_model

    from benchmark import correctness

    config, mix = _load(name), _load("tiny-train")
    rows = traffic.draw_rows(mix, config, 123)
    path = traffic.write_split(rows["train"], tmp_path / "train.json")
    data = {k: v for k, v in config["data"].items() if k != "loader_kwargs"}
    dm = TensorDataModule(str(path), str(path), str(path), root=str(tmp_path), reuse=False, seed=1,
                          loader_kwargs=config["data"]["loader_kwargs"], **data)
    dm.setup()
    ref = correctness.ReferenceData(config, {"train": path, "val": path})
    assert ref.stats.average_num_neighbors == pytest.approx(dm.statistics.average_num_neighbors, rel=1e-12)
    create = create_atomic_tensor_model if config["family"] == "atomic" else create_scalar_tensor_model
    model = create(dict(config["model"]), dm.get_to_model_info(), device="cpu", seed=0)
    weights = make_weights(((n, p.shape) for n, p in model.named_parameters()), 9, torch.device("cpu"))
    model.load_state_dict(weights, strict=False)
    ref_model = _ref_model(config, list(ref.stats.allowed_species), ref.stats.average_num_neighbors)
    ref_model.load_state_dict(weights, strict=False)
    batch = next(iter(dm.val_dataloader()))
    tensors = correctness._tensor_batch(batch, torch.device("cpu"))[0]
    model.train(), ref_model.train()
    out, want = model(dict(tensors)), ref_model(dict(tensors))
    assert torch.allclose(out, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(out.detach().numpy()).all()


@pytest.mark.parametrize("name", TINY)
def test_the_harness_collates_a_batch_as_the_loader_does(name, tmp_path):
    from matten_tpu_torch.data.datamodule import BatchLoader, TensorDataModule

    from benchmark.harness import Program

    config, mix = _load(name), _load("tiny-train")
    rows = traffic.draw_rows(mix, config, 77)
    path = traffic.write_split(rows["train"], tmp_path / "train.json")
    data = {k: v for k, v in config["data"].items() if k != "loader_kwargs"}
    dm = TensorDataModule(str(path), str(path), str(path), root=str(tmp_path), reuse=False, seed=1,
                          loader_kwargs=config["data"]["loader_kwargs"], **data)
    dm.setup()
    graphs = dm.graphs["train"][:4]
    loader = BatchLoader(graphs, batch_size=4, species_map=dm.species_map, num_buckets=1)
    want = next(iter(loader))
    prog = Program.__new__(Program)
    prog.loaders = {"train": loader}
    got = prog._collate("train", graphs, loader.pads[0])
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_array_equal(np.asarray(w[k]), np.asarray(g[k]), err_msg=k)
