"""The program's tracer (`utils.timing`) on the CPU: spans of the fit loop
and the step graphs, counters, and the layer and step marks, read through
a device clock that stands for the card's.

Off, a fit epoch records its "fit.epoch" span and nothing per step; on,
its spans come in a fixed order with their parents, step ids and self
times; the layer marks' autograd identity leaves the loss and every
gradient the same bits; an anchor maps the marks onto the host clock; the
Chrome trace it writes is read back by the benchmark's reader with its
idle gaps labelled by span; a step graph's key tells marks recorded
from none; and the marks' slots stay bounded however many steps run.
"""

import copy
import time

import numpy as np
import pytest
import torch

from benchmark.chrome_trace import Trace, trace_events
from matten_tpu_torch.data.datamodule import BatchLoader
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.predict import batch_to_device
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig
from matten_tpu_torch.train.graphs import StepGraphs
from matten_tpu_torch.utils import timing
from test_torch_step_graphs import DS, HPARAMS, SMAP, TARGET, _graphs

# the layers a train step of HPARAMS (one conv with its gate and batch norm,
# then the last conv) marks, forward and backward
LAYERS = ("embed", "fctp", "radial", "conv", "gate", "norm", "head", "loss", "adam")
BACKWARD = ("bwd.loss", "bwd.head", "bwd.fctp", "bwd.conv", "bwd.radial", "bwd.norm", "bwd.gate", "bwd.embed")


class Clock:
    """A device clock for the tracer's marks (`utils.timing.DeviceClock`'s
    methods, its slots Python lists): 5 ms ahead of the host's clock, or
    set by hand (`at`, in ms)."""

    def __init__(self, offset_ms=5.0):
        self.offset, self.at, self.buffers = int(offset_ms * 1e6), None, 0

    def now(self):
        return int(self.at * 1e6) if self.at is not None else timing._now() + self.offset

    def buffer(self, n):
        self.buffers += 1
        return [0] * n

    def stamp(self, buffer, i):
        buffer[i] = self.now()

    def sync(self):
        pass

    def read(self, buffers):
        return [list(b) for b in buffers]


@pytest.fixture(autouse=True)
def fresh():
    timing.disable()
    timing.clear()
    yield
    timing.disable()
    timing.clear()


def _trainer(normalization="batch"):
    graphs = _graphs(8, seed=3)
    data = type("Data", (), {"train_dataloader": lambda self: BatchLoader(graphs, 4, SMAP)})()
    data.val_dataloader = data.train_dataloader
    model = create_scalar_tensor_model(dict(HPARAMS, normalization=normalization), DS, device="cpu")
    return Trainer(model, [CanonicalRegressionTask(name=TARGET)], TrainerConfig(max_epochs=1, lr=0.01),
                   device="cpu"), data


def test_off_a_fit_epoch_records_no_per_step_span_counter_or_mark():
    """With the tracer off, a fit epoch records its "fit.epoch" span alone:
    no loader, feed, step, eval or epoch-end span, no counter, no read."""
    t, data = _trainer()
    t.fit(data)
    rec = timing.record()
    assert [s.name for s in rec.spans] == ["fit.epoch"] and rec.spans[0].epoch == 0
    assert rec.counters == {} and rec.reads == [] and not timing.marking()


def test_spans_nest_with_their_parent_step_and_self_time(monkeypatch):
    """Spans on a hand-set host clock: each records its enclosing span, the
    step it belongs to (the epoch, and the epoch's steps begun before it)
    and its ends; a span's self time is its length less its children's."""
    now = iter(range(0, 1000, 10))
    monkeypatch.setattr(timing, "_now", lambda: next(now))
    timing.enable()
    with timing.epoch(4):  # 0
        with timing.span("fit.loader"):  # 10 - 20
            pass
        with timing.span("fit.step"):  # 30
            with timing.span("graphs.replay"):  # 40 - 50
                pass
            with timing.span("graphs.replay"):  # 60 - 70
                pass
        with timing.span("fit.epoch_end"):  # 90
            with timing.span("fit.sync"):  # 100 - 110
                pass
    rec = timing.record()
    got = [(s.name, s.parent, s.epoch, s.index, s.start_ns, s.end_ns) for s in rec.spans]
    assert got == [("fit.epoch", -1, 4, 0, 0, 130), ("fit.loader", 0, 4, 0, 10, 20), ("fit.step", 0, 4, 0, 30, 80),
                   ("graphs.replay", 2, 4, 0, 40, 50), ("graphs.replay", 2, 4, 0, 60, 70),
                   ("fit.epoch_end", 0, 4, 1, 90, 120), ("fit.sync", 5, 4, 1, 100, 110)]
    assert rec.self_seconds("fit.step") == pytest.approx(30e-9)
    assert rec.self_seconds("fit.epoch") == pytest.approx((130 - 10 - 50 - 30) * 1e-9)
    assert rec.seconds("graphs.replay") == pytest.approx(20e-9)


def test_a_fit_epoch_emits_the_fixed_spans_in_order_and_marks_every_layer():
    """On, a fit epoch of 2 train and 2 eval batches (a group each):
    loader, feed and step per batch, the loader's end, the validation
    with its sync, the epoch end with its sync and the marks' read; the
    read holds both steps' pairs and every layer's device time, forward
    and backward, for the train steps, and the forward's for the eval."""
    t, data = _trainer()
    timing.enable(Clock())
    t.fit(data)
    rec = timing.record()
    batch = ["fit.loader", "fit.feed", "fit.step"]
    assert [s.name for s in rec.spans] == (["fit.epoch"] + batch * 2 + ["fit.loader", "fit.eval"] + batch * 2
                                           + ["fit.loader", "fit.sync", "fit.epoch_end", "fit.sync", "trace.read"])
    parent = {s.name: rec.spans[s.parent].name for s in rec.spans if s.parent >= 0}
    assert parent["fit.epoch_end"] == "fit.epoch" and parent["trace.read"] == "fit.epoch_end"
    assert [s.index for s in rec.spans if s.name == "fit.step"] == [0, 1, 2, 3]
    (read,) = rec.reads
    assert [k for k, *_ in read.steps] == ["train", "train", "eval", "eval"]
    assert read.layer_steps == {"train": 2, "eval": 2}
    assert set(read.layer_ms["train"]) == set(LAYERS + BACKWARD)
    assert set(read.layer_ms["eval"]) == set(LAYERS) - {"adam"}
    assert all(a <= b for _, a, b, _, _ in read.steps)
    # the eager train steps' shared slots hold the last one's layers, which
    # tile its marked interval
    last_ms = [b - a for kind, a, b, _, _ in read.steps if kind == "train"][-1] / 1e6
    assert sum(read.layer_ms["train"].values()) / read.layer_steps["train"] <= last_ms


@pytest.mark.parametrize("normalization", ["batch", None])
def test_layer_marks_leave_the_loss_and_every_gradient_the_same_bits(normalization):
    """Two copies of one model take a train step from the same batch, one
    with the tracer off, one with it on (marks recorded): the same loss,
    metric sums, gradients and updated parameters, bit for bit."""
    t, data = _trainer(normalization)
    batch = next(iter(data.train_dataloader()))
    twin = Trainer(copy.deepcopy(t.model), t.tasks, t.config, device="cpu")
    dev = batch_to_device(batch[0], "cpu", batch[1])
    loss_off, sums_off = t.train_step(*dev)
    timing.enable(Clock())
    loss_on, sums_on = twin.train_step(*dev)
    assert list(timing._T.eager) == ["train"] and timing._T.eager["train"].names[-1] is None
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(a, b) for a, b in zip(sums_off[TARGET], sums_on[TARGET]))
    for (n, p), q in zip(t.model.named_parameters(), twin.model.parameters()):
        assert torch.equal(p.grad, q.grad), n
        assert torch.equal(p, q), n


def test_the_anchor_maps_marks_onto_the_host_clock(monkeypatch):
    """Step marks at hand-set device times (a step's start recorded again
    at its launch), the device's clock 1000 ms behind the host's: each
    read maps them onto the host clock through its
    anchor (the device's time of the anchor less the mark's, taken from
    the host's time of the anchor), and reports the clocks' drift between
    two anchors; the layer segments of the last step come with their device ms."""
    host = {"ns": 0}
    monkeypatch.setattr(timing, "_now", lambda: host["ns"])
    clock = Clock()
    clock.at = 0.0
    timing.enable(clock)  # anchor: host 0 ns, device 0 ms
    with timing.epoch(0):
        for start in (10.0, 20.0):
            clock.at = start - 0.5
            started = timing.step_start("train")
            clock.at = start  # a replay's inputs copied in: its pair starts at the launch
            timing.step_launch()
            timing.begin_step("train")
            timing.mark("fctp")
            clock.at = start + 3.0
            timing.mark("conv")
            clock.at = start + 4.0
            timing.end_step()
            timing.step_end(started)
        clock.at, host["ns"] = 30.0, 1_000_000_000 + 30_000_000  # the host's clock 1 s ahead
        timing.read_marks()
    (read,) = timing.record().reads
    assert [(a, b) for _, a, b, _, _ in read.steps] == [(1_010_000_000, 1_014_000_000),
                                                        (1_020_000_000, 1_024_000_000)]
    assert read.layer_ms == {"train": {"fctp": 6.0, "conv": 2.0}} and read.layer_steps == {"train": 2}
    # the segments of the last eager step, which the two steps' shared slots hold
    assert read.segments == [("fctp", 1_020_000_000, 1_023_000_000), ("conv", 1_023_000_000, 1_024_000_000)]
    assert read.anchor_ns == 1_030_000_000 and read.drift_ns == 1_000_000_000


def test_a_replayed_graph_s_marks_count_once_per_replay(monkeypatch):
    """The marks made under a capture are the graph's: a read weighs their
    last recording by the graph's replays since the last read, then starts
    its count again."""
    clock = Clock()
    timing.enable(clock)
    monkeypatch.setattr(timing, "_capturing", lambda: True)
    timing.begin_step("train")
    monkeypatch.undo()
    assert timing._T.eager == {}
    clock.at = 0.0
    timing.mark("fctp")
    clock.at = 2.0
    timing.end_step()
    marks = timing.captured_marks()
    assert timing.captured_marks() is None
    for _ in range(3):
        timing.replayed(marks)
    clock.at = 5.0
    timing.read_marks()
    timing.read_marks()
    first, second = timing.record().reads
    assert first.layer_ms == {"train": {"fctp": 6.0}} and first.layer_steps == {"train": 3}
    assert second.layer_ms == {} and marks.runs == 0


def test_eager_steps_share_one_set_of_slots_per_kind():
    """The eager steps of a kind write their layer marks into one set of
    slots, over the last step's: a read weighs the last by the steps of
    its kind, and no step makes a buffer of its own."""
    clock = Clock()
    timing.enable(clock)
    made = clock.buffers
    for kind, ms in (("train", 2.0), ("eval", 1.0), ("train", 3.0)):
        clock.at = 0.0
        timing.begin_step(kind)
        timing.mark("conv")
        clock.at = ms
        timing.end_step()
    assert clock.buffers == made + 2 and sorted(timing._T.eager) == ["eval", "train"]
    timing.read_marks()
    (read,) = timing.record().reads
    assert read.layer_ms == {"train": {"conv": 6.0}, "eval": {"conv": 1.0}}
    assert read.layer_steps == {"train": 2, "eval": 1}
    made = clock.buffers
    timing.begin_step("train")
    timing.end_step()
    timing.read_marks()
    assert clock.buffers == made + 1  # the anchor's slot alone
    assert timing.record().reads[-1].layer_steps == {"train": 1}


def test_a_full_step_pool_is_read_as_the_next_step_starts(monkeypatch):
    """The step marks' pool holds STEP_POOL pairs: the step that finds it
    full reads the marks first (a read of the steps before it) and takes
    the pool's first pair, so no pool is added."""
    monkeypatch.setattr(timing, "STEP_POOL", 2)
    clock = Clock()
    timing.enable(clock)
    made = clock.buffers
    with timing.epoch(0):
        for _ in range(5):
            with timing.span("fit.step"):
                timing.step_end(timing.step_start("train"))
    assert [len(r.steps) for r in timing.record().reads] == [2, 2]
    assert [ix for _, _, _, _, ix in timing.record().reads[1].steps] == [2, 3]
    assert timing._T.used == 1 and clock.buffers == made + 2  # the two reads' anchors


def test_the_exported_trace_is_read_back_with_idle_gaps_labelled_by_span(tmp_path, monkeypatch):
    """`export_chrome_trace` writes the spans as host ranges and the step
    marks as device ranges; the benchmark's trace reader takes its busy
    union from the marks and labels each idle gap between them by the
    innermost span over the gap's midpoint: here the device waits 8-10 ms
    while the host feeds the second step."""
    host = {"ns": 0}
    monkeypatch.setattr(timing, "_now", lambda: host["ns"])

    def at(ms):
        host["ns"] = int(ms * 1e6)

    clock = Clock()
    clock.at = 0.0
    timing.enable(clock)
    with timing.epoch(0):
        for feed, step, device in ((0.0, 2.0, (2.0, 8.0)), (3.0, 10.0, (10.0, 15.0))):
            at(feed)
            with timing.span("fit.feed"):
                at(step)
            with timing.span("fit.step"):
                clock.at = device[0]
                started = timing.step_start("train")
                clock.at = device[1]
                timing.step_end(started)
                at(step + 1.0)
        at(11.0)
        with timing.span("fit.epoch_end"):
            clock.at = 16.0
            at(16.0)
            timing.read_marks()
    path = tmp_path / "spans.json"
    timing.export_chrome_trace(str(path))
    trace = Trace(trace_events(path))
    assert trace.busy_s == pytest.approx(0.011) and trace.seconds("step.train") == pytest.approx(0.011)
    assert {n for n, _, _ in trace.host} == {"fit.epoch", "fit.feed", "fit.step", "fit.epoch_end", "trace.read"}
    assert trace.idle_gaps() == [["fit.feed", pytest.approx(0.002)]]


def test_a_step_graph_s_key_holds_whether_the_tracer_is_on():
    """A graph captured with the layer marks is never replayed with the
    tracer off, nor one captured without them with it on; the tracer on
    without marks (spans and counters only) keys the graphs of the tracer
    off."""
    graphs = StepGraphs({})
    data = {"x": torch.zeros(3)}
    off = graphs.key("train", data, {})
    timing.enable(Clock())
    on = graphs.key("train", data, {})
    timing.disable()
    timing.enable(Clock(), marks=False)
    counting = graphs.key("train", data, {})
    assert off != on and off[5] is False and on[5] is True and off[-1] == on[-1]
    assert counting == off and timing.enabled() and not timing.marks_on()


def test_on_without_marks_a_fit_epoch_records_spans_and_no_mark():
    """`enable(marks=False)`: the fit epoch's spans as with marks, no step
    or layer mark and no read."""
    t, data = _trainer()
    clock = Clock()
    timing.enable(clock, marks=False)
    t.fit(data)
    rec = timing.record()
    assert {"fit.loader", "fit.feed", "fit.step", "fit.eval", "fit.epoch_end", "fit.sync"} <= {s.name for s in rec.spans}
    assert rec.reads == [] and clock.buffers == 0 and timing._T.eager == {}


def test_counters_and_per_step_spans_only_while_on_and_always_spans_always():
    """`count` and a per-step span record nothing while the tracer is off;
    an always span records either way; `clear` inside a span raises."""
    timing.count("graphs.replays")
    with timing.span("fit.feed"):
        pass
    with timing.span("graphs.capture", always=True):
        with pytest.raises(RuntimeError):
            timing.clear()
    with timing.tracing():
        timing.count("graphs.replays", 2)
        with timing.span("fit.feed"):
            time.sleep(0.001)
        assert timing.enabled()
    assert not timing.enabled()
    rec = timing.record()
    assert [s.name for s in rec.spans] == ["graphs.capture", "fit.feed"]
    assert rec.counters == {"graphs.replays": 2} and rec.seconds("fit.feed") >= 1e-3
    assert np.isfinite(rec.self_seconds("graphs.capture"))
