"""The program's own spans, counters and marks in a traced run
(`--trace 1`): one phase after the profiled epochs, run once by the first
reader that needs it, its record shared by the readers of the tracer's
metrics (`metrics/feed_ms_per_step.py`, `launch_ms_per_step.py`,
`epoch_end_ms_per_step.py`, `fctp_device_ms.py`, `graph_setup_s.py`).

The phase: the step graphs of the untraced and profiled epochs freed
(`Trainer.free_graphs`, which also lets go of the CUPTI that the profiled
epochs left attached), the tracer turned on
(`matten_tpu_torch.utils.timing`), every pad shape of both ladders warmed
again (`warm_every_shape`: a first sight and a capture each, so that the
graphs hold the layer marks; an epoch need not hold a batch of the largest
shape), `WARM_EPOCHS` whole `fit` epochs and `SPANNED_EPOCHS` epochs whose
spans, counters and marks the metrics read;
then the tracer off and the trainer's state (model, optimizer,
scheduler) and history as they were, so that what the harness reads of
the trainer after its readers (the history) is what it would read without
the phase. The untraced and profiled epochs before it run as they did
without it.

A reader is handed the harness's `Span` alone, and the phase needs the
run's trainer and data module: it takes the `Program` of the harness's
`_traced` call that is reading its metrics, from that call's frame. With
a program that has no tracer, every reader reads None and nothing runs;
with a tracer but outside such a call, a reader raises. The phase's host
split, device ms by layer, idle time by span, the tracer's cost and its
coverage go to standard error as one "spanned:" line.
"""

from __future__ import annotations

import copy
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

WARM_EPOCHS = 1
SPANNED_EPOCHS = 2
# the spans whose seconds in set-up are the program's share of `setup_s`,
# less the kernels' build and load inside them (LOAD_SPAN: the first run
# in a checkout compiles them there)
SETUP_SPANS = ("graphs.first_sight", "graphs.capture")
LOAD_SPAN = "kernels.load"

__all__ = ["WARM_EPOCHS", "SPANNED_EPOCHS", "Spanned", "result", "warm_every_shape"]


class Spanned:
    """The tracer's record of the spanned epochs (`record`, a
    `utils.timing.Record`), the set-up's seconds in `SETUP_SPANS` (None
    where set-up recorded none: no step graphs), and the spanned epochs'
    host seconds."""

    def __init__(self, record, setup_s: Optional[float], seconds: float):
        self.record, self.setup_s, self.seconds = record, setup_s, seconds
        by = {i: s.name for i, s in enumerate(record.spans)}
        steps = [s for s in record.spans if s.name == "fit.step"]
        # a train step's span sits in its epoch's; an eval step's in "fit.eval"
        self.train_steps = sum(by.get(s.parent) == "fit.epoch" for s in steps)
        self.replayed = bool(steps) and record.counters.get("graphs.replays", 0) >= len(steps)

    def per_step_ms(self, name: str, own: bool = False) -> Optional[float]:
        """The ms of every span of `name` (less their child spans', with
        `own`) per train step; None unless every spanned step was a replay."""
        if not self.replayed or not self.train_steps:
            return None
        s = self.record.self_seconds(name) if own else self.record.seconds(name)
        return 1e3 * s / self.train_steps

    def layer_ms(self) -> Dict[str, float]:
        """The device ms per train step of each mark name; empty unless every
        spanned step was a replay."""
        reads = self.record.reads
        steps = sum(r.layer_steps.get("train", 0) for r in reads)
        if not self.replayed or not steps:
            return {}
        out: Dict[str, float] = {}
        for r in reads:
            for name, ms in r.layer_ms.get("train", {}).items():
                out[name] = out.get(name, 0.0) + ms / steps
        return out


def _tracer():
    """The program's tracer module, or None where the program has none."""
    from matten_tpu_torch.utils import timing

    return timing if hasattr(timing, "export_chrome_trace") else None


def _program():
    """The `Program` of the harness's `_traced` call that this reader runs in."""
    from benchmark import harness

    frame = sys._getframe(1)
    while frame is not None and frame.f_code is not harness._traced.__code__:
        frame = frame.f_back
    if frame is None:
        raise RuntimeError("spanned: a reader of the tracer's metrics ran outside the harness's traced run, "
                           "which holds the program it measures")
    return frame.f_locals["prog"]


def _setup_seconds(record, span) -> Optional[float]:
    """Seconds of `SETUP_SPANS` that ended before the set-up's last epoch
    did (every epoch but the untraced and profiled ones is set-up's), less
    the `LOAD_SPAN`s inside them."""
    epochs = [s for s in record.spans if s.name == "fit.epoch"]
    setup = len(epochs) - span.timed_epochs - span.traced_epochs
    if setup <= 0:
        return None
    end = epochs[setup - 1].end_ns
    spans = [i for i, s in enumerate(record.spans) if s.name in SETUP_SPANS and s.end_ns <= end]
    if not spans:
        return None
    inside = set(spans)

    def within(s) -> bool:
        while s.parent >= 0:
            if s.parent in inside:
                return True
            s = record.spans[s.parent]
        return False

    ns = sum(record.spans[i].end_ns - record.spans[i].start_ns for i in spans)
    ns -= sum(s.end_ns - s.start_ns for s in record.spans if s.name == LOAD_SPAN and within(s))
    return ns * 1e-9


def warm_every_shape(prog) -> None:
    """One `fit` epoch of two train batches at every shape of the train
    loader's ladder and two validation batches at every shape of the
    validation loader's, of the split's smallest crystals (as
    `Program.warm_shapes`, the largest shapes included)."""
    from benchmark.harness import fit_once

    batches = {}
    for split, loader in prog.loaders.items():
        small = sorted(loader.graphs, key=lambda g: (g.num_edges, g.num_nodes))[:loader.batch_size]
        batches[split] = [prog._collate(split, small, pad) for pad in loader.pads for _ in range(2)]
    fit_once(prog.trainer, batches["train"], batches["val"])


def result(span) -> Optional[Spanned]:
    """The phase's record for this run (run at the first call, kept on `span`)."""
    if not hasattr(span, "spanned"):
        timing = _tracer()
        span.spanned = None if timing is None else _run(timing, _program(), span)
    return span.spanned


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(timing, prog, span) -> Spanned:
    from benchmark.chrome_trace import Trace, trace_events
    from benchmark.harness import fit_epochs
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.train.graphs import COUNTERS

    setup_s = _setup_seconds(timing.record(), span)
    trainer = prog.trainer
    history = len(trainer.history)
    state = copy.deepcopy(trainer.state_dict())
    trainer.free_graphs()
    timing.enable()
    try:
        warm_every_shape(prog)
        fit_epochs(trainer, prog.dm, lambda done: done >= WARM_EPOCHS)
        _sync(prog.device)
        timing.clear()
        launches = sum(getattr(fused_conv, c) for c in COUNTERS)
        start = time.perf_counter()
        epochs = fit_epochs(trainer, prog.dm, lambda done: done >= SPANNED_EPOCHS)
        _sync(prog.device)
        seconds = time.perf_counter() - start
        launches = sum(getattr(fused_conv, c) for c in COUNTERS) - launches
        record = timing.record()
        with tempfile.TemporaryDirectory(prefix="bench-spans-") as tmp:
            path = Path(tmp) / "spans.json"
            timing.export_chrome_trace(str(path))
            trace = Trace(trace_events(path))
    finally:
        timing.disable()
        del trainer.history[history:]
        trainer.load_state_dict(state)
    out = Spanned(record, setup_s, seconds)
    _report(out, trace, span, len(epochs.log["train"]), launches)
    return out


def _report(out: Spanned, trace, span, train_steps: int, launches: int) -> None:
    """The "spanned:" line on standard error: what the result line has no key for."""
    rec, n = out.record, max(train_steps, 1)
    spans = {name: sum(s.name == name for s in rec.spans) for name in
             ("graphs.first_sight", "graphs.capture", "graphs.drop")}
    host = {name: 1e3 * rec.self_seconds(name) / n for name in
            ("fit.loader", "fit.feed", "graphs.replay", "fit.step", "fit.eval", "fit.epoch_end", "fit.sync",
             "trace.read", "fit.epoch", "graphs.first_sight", "graphs.capture")}
    timed_steps = len(span.timed["train"])
    layers = out.layer_ms()
    steps_busy_ms = 1e3 * trace.busy_s / n
    profiled_ms = 1e3 * span.trace.busy_s / max(len(span.traced["train"]), 1)
    per_epoch = {}
    for kind in ("train", "eval"):
        for r in rec.reads:
            for name, ms in r.layer_ms.get(kind, {}).items():
                per_epoch[name] = per_epoch.get(name, 0.0) + ms / max(len(rec.reads), 1)
    traced = max(span.traced_epochs, 1)
    line = {
        "train_steps": train_steps, "replayed": out.replayed, "counters": rec.counters, "spans": spans,
        "conv_launches": launches,
        "host_ms_per_step": {"spanned": 1e3 * out.seconds / n,
                             "untraced": 1e3 * span.timed_s / timed_steps if timed_steps else None,
                             "self_by_span": host},
        "layers_ms_per_step": layers, "layers_sum_ms": sum(layers.values()),
        "step_marks_busy_ms_per_step": steps_busy_ms, "profiled_step_device_ms": profiled_ms,
        "train_step_marks_ms_per_step": sum((b - a) * 1e-6 for r in rec.reads for kind, a, b, _, _ in r.steps
                                            if kind == "train") / n,
        "conv_ms_per_epoch": {"marks": per_epoch.get("conv", 0.0),
                              "profiled": 1e3 * (span.trace.seconds("fused_uvu_conv_fwd")
                                                 + span.trace.seconds("segment_sum_kernel", "false>")) / traced},
        "bwd_conv_ms_per_epoch": {"marks": per_epoch.get("bwd.conv", 0.0),
                                  "profiled": 1e3 * (span.trace.seconds("fused_uvu_conv_bwd")
                                                     + span.trace.seconds("segment_sum_kernel", "true>")) / traced},
        "idle_by_span": trace.idle_gaps(), "drift_ns": [r.drift_ns for r in rec.reads],
        "graph_setup_s": out.setup_s,
    }
    print("spanned: " + json.dumps(line), file=sys.stderr)
