"""The readers of the program's tracer (`spanned.py`, `metrics/*`), each on
a synthetic record: the spans, counters and marks of two spanned epochs of
two train steps and one eval step each, every step a replay."""

import types

import pytest

from benchmark import harness, spanned
from matten_tpu_torch.utils.timing import Read, Record, SpanRecord

MS = 1_000_000  # ns


def _epoch(spans, epoch, t0):
    """One epoch's spans from `t0` ms, as the fit loop nests them: per train
    step a loader (1 ms), feed (2 ms: 0.5 of it a child span) and step (4
    ms, 3 of them its replay), then the validation (one such step) and the
    epoch end (3 ms, a 1 ms sync and a 0.5 ms read inside it)."""
    top = len(spans)
    spans.append(SpanRecord("fit.epoch", -1, epoch, 0, t0 * MS, 0))
    t = t0

    def add(name, parent, length):
        nonlocal t
        spans.append(SpanRecord(name, parent, epoch, 0, t * MS, (t + length) * MS))
        t += length
        return len(spans) - 1

    def step(parent):
        nonlocal t
        add("fit.loader", parent, 1)
        feed = add("fit.feed", parent, 2)
        t -= 2
        add("graphs.check", feed, 0.5)
        t += 1.5
        s = add("fit.step", parent, 4)
        t -= 4
        add("graphs.replay", s, 3)
        t += 1

    step(top)
    step(top)
    ev = len(spans)
    spans.append(SpanRecord("fit.eval", top, epoch, 2, t * MS, 0))
    step(ev)
    spans[ev] = spans[ev]._replace(end_ns=t * MS)
    end = add("fit.epoch_end", top, 3)
    t -= 3
    add("fit.sync", end, 1)
    add("trace.read", end, 0.5)
    t += 1.5
    spans[top] = spans[top]._replace(end_ns=t * MS)
    return t


def _record(replays=6):
    spans = []
    t = _epoch(spans, 0, 0)
    _epoch(spans, 1, t)
    reads = [Read(e, [], {"train": {"fctp": 2.0, "bwd.fctp": 3.0, "conv": 1.0}, "eval": {"fctp": 9.0}},
                  {"train": 2, "eval": 1}, [], 0, 0) for e in (0, 1)]
    return Record(spans, {"graphs.replays": replays}, reads)


def _span(record, setup_s=12.5):
    return types.SimpleNamespace(spanned=spanned.Spanned(record, setup_s, 0.05))


@pytest.mark.parametrize("name,value", [
    ("feed_ms_per_step.train", 3 * 1.5 * 2 / 4),  # 3 feeds an epoch, 1.5 ms own, over 4 train steps
    ("launch_ms_per_step.nmr", 3 * 3.0 * 2 / 4),
    ("epoch_end_ms_per_step.train", 1.5 * 2 / 4),  # 3 ms less the sync and the read
    ("fctp_device_ms.nmr", (2.0 + 3.0) * 2 / 4),  # the train steps' fctp and bwd.fctp only
    ("graph_setup_s", 12.5),
])
def test_each_reader_reads_its_quantity(name, value):
    assert harness.metric_reader(name)(_span(_record())) == pytest.approx(value)


@pytest.mark.parametrize("name", ["feed_ms_per_step.train", "launch_ms_per_step.train",
                                  "epoch_end_ms_per_step.nmr", "fctp_device_ms.train"])
def test_a_step_that_was_not_a_replay_leaves_the_per_step_readers_silent(name):
    """Fewer replays than spanned steps: a step ran eagerly or was captured."""
    assert harness.metric_reader(name)(_span(_record(replays=5))) is None
    assert harness.metric_reader("graph_setup_s")(_span(_record(replays=5))) == 12.5


def test_a_program_without_a_tracer_runs_nothing(monkeypatch):
    """On a program that lacks the tracer, every reader reads None and the
    phase does not run."""
    monkeypatch.setattr(spanned, "_tracer", lambda: None)
    monkeypatch.setattr(spanned, "_run", lambda *a: pytest.fail("the phase ran"))
    span = types.SimpleNamespace()
    assert harness.metric_reader("feed_ms_per_step.train")(span) is None
    assert harness.metric_reader("graph_setup_s")(span) is None


def test_the_set_up_s_graph_spans_end_before_the_timed_epochs():
    """`graph_setup_s` counts the first sights and captures of the epochs
    before the untraced and profiled ones, not a capture inside those."""
    spans = [SpanRecord("fit.epoch", -1, 0, 0, 0, 10 * MS), SpanRecord("graphs.first_sight", 0, 0, 0, 1, 2 * MS + 1),
             SpanRecord("graphs.capture", 0, 0, 0, 3 * MS, 7 * MS), SpanRecord("fit.epoch", -1, 0, 0, 11 * MS, 20 * MS),
             SpanRecord("graphs.capture", 3, 0, 0, 12 * MS, 15 * MS)]
    rec = Record(spans, {}, [])
    assert spanned._setup_seconds(rec, types.SimpleNamespace(timed_epochs=1, traced_epochs=0)) == pytest.approx(6e-3)
    assert spanned._setup_seconds(rec, types.SimpleNamespace(timed_epochs=1, traced_epochs=1)) is None


def test_the_kernels_build_inside_a_first_sight_is_not_set_up_s():
    """The kernels' build and load ("kernels.load", inside the first step
    that launches one) is taken out of the first sight that holds it; one
    outside every graph span is not counted at all."""
    spans = [SpanRecord("fit.epoch", -1, 0, 0, 0, 20 * MS), SpanRecord("kernels.load", -1, 0, 0, 0, MS),
             SpanRecord("graphs.first_sight", 0, 0, 0, 2 * MS, 12 * MS),
             SpanRecord("kernels.load", 2, 0, 0, 3 * MS, 10 * MS), SpanRecord("graphs.capture", 0, 0, 0, 13 * MS, 15 * MS)]
    rec = Record(spans, {}, [])
    assert spanned._setup_seconds(rec, types.SimpleNamespace(timed_epochs=0, traced_epochs=0)) == pytest.approx(5e-3)


def test_a_reader_outside_the_harness_s_traced_run_raises():
    """With the tracer there, a reader that finds no traced run of the
    harness to take the program from raises rather than reading None."""
    with pytest.raises(RuntimeError, match="outside the harness's traced run"):
        harness.metric_reader("feed_ms_per_step.train")(types.SimpleNamespace())


def _state(trainer):
    """What the harness could read of the trainer: its model's and
    optimizer's tensors, each group's lr, the scheduler and the history."""
    import copy

    opt = trainer.optimizer.state_dict()
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            [{k: v.clone() if hasattr(v, "clone") else v for k, v in s.items()} for s in opt["state"].values()],
            [g["lr"] for g in trainer.optimizer.param_groups],
            None if trainer.scheduler is None else copy.deepcopy(vars(trainer.scheduler)),
            copy.deepcopy(trainer.history))


def _same(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_the_phase_leaves_the_trainer_as_it_found_it(tiny, bench, monkeypatch):
    """A traced run on the CPU: the trainer that the readers after the
    phase's (and the harness after its readers) see is the one that the
    readers before it saw: parameters, buffers, Adam's state, the lr, the
    scheduler and the history."""
    import torch

    seen = {}
    read_by_name = tiny.metric_reader

    def reader(name):
        read = read_by_name(name)

        def wrapped(span):
            prog = spanned._program()
            seen.setdefault("before", _state(prog.trainer))
            value = read(span)
            seen["after"] = _state(prog.trainer)
            seen["ran"] = seen.get("ran", False) or getattr(span, "spanned", None) is not None
            return value

        return wrapped

    monkeypatch.setattr(tiny, "metric_reader", reader)
    cell = {"name": "nmr-train", "config": "tiny-matten-nmr-si", "traffic": "tiny-train", "chips": 1}
    out = tiny.run_cell(bench, cell, 2**31 + 9, 0.5, True, torch.device("cpu"), 0.0)
    assert out["correct"] and seen["ran"]
    assert _same(seen["before"], seen["after"])
