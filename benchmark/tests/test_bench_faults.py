"""A whole run on the CPU at a tiny size, the look for a card skipped: a
sound run comes out correct, and each fault a training cell on one card
can have, planted in the port's step underneath, comes out not correct.
The control (the reference in TF32) runs on the card only."""

import pytest
import torch

TINY = ("tiny-matten-elasticity-s73", "tiny-matten-nmr-si")
# each tiny configuration stands in a real cell's place, with its metrics
CELL = {"tiny-matten-elasticity-s73": "elasticity-train", "tiny-matten-nmr-si": "nmr-train"}


def _run(harness, bench, config, trace=False, chips=1):
    cell = {"name": CELL[config], "config": config, "traffic": "tiny-train", "chips": chips}
    return harness.run_cell(bench, cell, 2**31 + 5, 0.5, trace, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("config", TINY)
@pytest.mark.parametrize("trace", (False, True), ids=("window", "traced"))
def test_a_sound_run_is_correct(tiny, bench, config, trace):
    out = _run(tiny, bench, config, trace)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap", "eval_gap"}
    cell = {"name": CELL[config]}
    if trace:
        # on the CPU the trace holds no device operation: only the host's shares read
        names = {m["name"] for m in tiny.reported(bench["per_layer"], cell)
                 if m["name"].split(".")[0] in ("loader_ms_per_batch", "step_mfu_pct")}
        assert len(names) == 2
    else:
        names = {m["name"] for m in tiny.reported(bench["end_to_end"], cell)}
        assert "setup_s" in names and len(names) == 3
    assert names <= set(out["metrics"]) and out["device"]["count"] == 1


def test_a_cell_of_more_cards_than_the_harness_drives_is_refused(tiny, bench):
    with pytest.raises(ValueError, match="drives one"):
        _run(tiny, bench, TINY[0], chips=4)


def _state_unchanged(monkeypatch):
    from matten_tpu_torch.train.trainer import Trainer

    real = Trainer._train_step

    def step(self, data, targets):
        saved = [p.detach().clone() for p in self.model.parameters()]
        state = {p: {k: v.clone() for k, v in s.items()} for p, s in self.optimizer.state.items()}
        out = real(self, data, targets)
        with torch.no_grad():
            for p, v in zip(self.model.parameters(), saved):
                p.copy_(v)
        for p, s in state.items():
            for k, v in s.items():
                self.optimizer.state[p][k].copy_(v)
        for p in self.model.parameters():
            if p not in state:
                self.optimizer.state.pop(p, None)
        return out

    monkeypatch.setattr(Trainer, "_train_step", step)


def _half_batch(monkeypatch):
    from matten_tpu_torch.train.trainer import Trainer

    real = Trainer._task_mask

    def mask(self, task, data, targets):
        m = real(self, task, data, targets).clone()
        if task.per_atom:
            return m & (data["batch"] < data["graph_mask"].sum() // 2)
        m[int(m.sum()) // 2:] = False
        return m

    monkeypatch.setattr(Trainer, "_task_mask", mask)


def _eval_answer_altered(monkeypatch):
    from matten_tpu_torch.train.trainer import Trainer

    real = Trainer._preds

    def preds(self, data):
        out = real(self, data)
        return out if self.model.training else {k: v * 1.001 for k, v in out.items()}

    monkeypatch.setattr(Trainer, "_preds", preds)


@pytest.mark.parametrize("config", TINY)
@pytest.mark.parametrize("fault", (_state_unchanged, _half_batch, _eval_answer_altered),
                         ids=("state_unchanged", "half_batch", "eval_answer_altered"))
def test_a_fault_in_the_step_is_not_correct(tiny, bench, config, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(tiny, bench, config)
    assert not out["correct"]
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(c["value"] > limits[k] for k, c in out["checks"].items())


@pytest.mark.gpu
@pytest.mark.parametrize("config", ("matten-elasticity-s73", "matten-nmr-si"))
def test_the_tf32_control_fails_the_limits(config, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from benchmark import correctness
    from benchmark.harness import Program, load

    device = torch.device("cuda")
    cfg, mix = load("configs", config), load("traffic", "train")
    prog = Program(cfg, mix, 2**31 + 77, device, tmp_path)
    weights, rows = prog.weights, prog.rows
    prog.free()
    ref = correctness.ReferenceData(cfg, prog.files)
    want = correctness.reference_readings(ref, rows, weights, device)
    control = correctness.reference_readings(ref, rows, weights, device, tf32=True)
    assert not correctness.judge(correctness.compare(control, want), cfg["limits"])
