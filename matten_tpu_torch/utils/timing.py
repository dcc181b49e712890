"""The program's tracer, and profiler traces.

The tracer (`enable` / `disable`, or `tracing()`; off by default) records
where the fit loop's and the step graphs' host time goes and, on the card,
where a step's device time goes, on one clock, at a cost far below the
profiler's:

* spans: a name, the enclosing span, the step they belong to (the epoch,
  and the steps of the epoch begun before them) and their start and end in
  `time.perf_counter_ns()`, kept in memory (`record()`, `clear()`). The
  spans that open at most once a step shape or an epoch (`span(name,
  always=True)`: a fit epoch, a graph's first sight, capture and drop) are
  recorded whether the tracer is on or not; per-step spans only while it
  is on: off, `span` is one global check and a shared no-op context. While
  a `torch.profiler` session runs, a span recorded while the tracer is on
  is also a `record_function` range of its name in that trace;
* counters (`count`), kept at the same boundaries while it is on;
* marks, on the card, unless the tracer was turned on without them
  (`enable(marks=False)`: spans and counters only): the device's
  nanosecond timer written into a slot on the stream (`DeviceClock`, a
  one-thread kernel, `kernels/csrc/marks.cu`) around each step
  (`step_start` / `step_end`, pairs of one pool of STEP_POOL made as the
  tracer turns on; a replay's starts at its launch, `step_launch`), and
  inside a step's model at each layer boundary (`begin_step`, `mark`,
  `grad_mark`, `end_step`), so that a CUDA graph capture bakes the layer
  marks into the graph as kernel nodes and every replay writes them again;
  `grad_mark`'s autograd identity marks the backward's boundaries. A
  graph's layer marks hold its last replay, and the eager steps of a kind
  share one set of slots, which holds the last of them; each counts for
  the steps it stands for. They are read at the fit loop's epoch-end sync
  (`read_marks`), or as a step starts once the pool is full, mapped onto
  the host clock by an anchor (a mark, an event waited on, and
  `perf_counter_ns` read) taken as the tracer turns on and at each read.
  So the device memory the marks hold is bounded whoever runs the steps;
  the spans and reads stay in host memory until `clear()`;
* `export_chrome_trace(path)` writes the spans (host ranges) and the marks
  (device ranges) as a Chrome trace.

Whether the tracer records marks is part of a step graph's key
(`train.graphs.StepGraphs.key`, `marks_on`): a graph captured with marks
is never replayed without them, and one captured with the tracer off (or
on without marks) holds no mark and is the same graph either way.

Profiler traces: `profile_trace` writes a `torch.profiler` trace (Chrome
trace JSON, with CUDA activity when a card is present), the counterpart of
the jax profiler's in `matten_tpu/utils/timing.py`. Every session is a
`profiler()`, which keeps CUPTI attached between sessions while the step
graphs it traced live, and `release_cupti` tears it down as one of them is
freed, so that the card's step graphs, those that hold NCCL collectives
included, are traced in sessions in turn. `traced_before_free` runs an
eager forward under the profiler before step graphs are freed, inside the
running session or, once a session has ended, in one of its own, without
which a later session's graph launch faulted in CUPTI. Where the user (or
torch.compile) has set TEARDOWN_CUPTI, that repair does not hold: once
step graphs are freed in or after a session, later sessions are refused
with a RuntimeError (`_Profile`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["FREE_RANGE", "profiler", "profile_trace", "release_cupti", "traced_before_free",
           "enable", "disable", "tracing", "enabled", "marks_on", "span", "epoch", "count", "begin_step", "mark",
           "grad_mark", "marking", "end_step", "captured_marks", "replayed", "step_start", "step_launch",
           "step_end", "read_marks", "record", "clear", "export_chrome_trace", "DeviceClock", "SpanRecord", "Read",
           "Record"]


# CUPTI, the card's tracing interface, as this module's sessions leave it:
# "wrote" the TEARDOWN_CUPTI value the module last set, "kept" whether the
# last session ended with CUPTI attached, "dropped" whether a step graph
# was freed during the running session, "started" whether a session of
# this module has started in this process, "refuse" why every later
# session is refused (None: none is) (`_Profile`, `release_cupti`)
_cupti = {"wrote": None, "kept": False, "dropped": False, "started": False, "refuse": None}

# the range of the trace that holds `traced_before_free`'s forward when a
# session is running as step graphs are freed
FREE_RANGE = "matten_tpu_torch.traced_before_free"


def _sets_teardown() -> bool:
    """Whether TEARDOWN_CUPTI is the port's to set: unset, or as the port
    last set it. A value that the user or torch set is left as it is, and
    so is every value once DISABLE_CUPTI_LAZY_REINIT is set (torch.compile's
    CUDA graphs set both, to keep CUPTI attached for the whole process)."""
    return (os.environ.get("TEARDOWN_CUPTI") in (None, _cupti["wrote"])
            and "DISABLE_CUPTI_LAZY_REINIT" not in os.environ)


def _set_teardown(value: str) -> None:
    os.environ["TEARDOWN_CUPTI"] = _cupti["wrote"] = value


def _refusal() -> str:
    """The message of a session refused after step graphs were freed in or
    after a session while TEARDOWN_CUPTI was not the port's to set."""
    names = [k for k in ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT") if k in os.environ]
    return (f"profiler session refused: step graphs were freed in or after a profiler session while "
            f"{' and '.join(f'{k}={os.environ[k]}' for k in names)} was set outside the port, and a later "
            f"session's launch of a step graph then dies inside CUPTI (a segmentation fault in libcupti, called "
            f"from cuGraphLaunch). Unset {' and '.join(names)} before the process starts and let the port manage "
            f"CUPTI's teardown (matten_tpu_torch.utils.timing).")


class _Profile(torch.profiler.profile):
    """`torch.profiler.profile` that keeps CUPTI attached past its end
    while a step graph lives (`train.graphs.live_graphs`), until one is
    freed (`release_cupti`).

    Kineto, torch.profiler's tracer, tears CUPTI down when a session ends
    (unless `TEARDOWN_CUPTI=0`, read as the session ends) and attaches it
    anew at the next one. Torch's own profiler turns that teardown off for
    the CUDA graphs of torch.compile (`torch/profiler/profiler.py`,
    `_KinetoProfile.start_trace`: "CUDA Graph does not work well with CUPTI
    teardown ... Workaround: turn off CUPTI teardown when using CUDA
    Graphs"), but not for a `torch.cuda.graph` capture like the step
    graphs'. On H100s under torch 2.11 (CUDA 12.8, CUPTI 12.8, NCCL 2.28),
    with the teardown a graph replayed in a session ran in later sessions
    with none of its kernels in the trace (`chip_smoke.py::graph_probe`'s
    (a)); so CUPTI stays attached while the graphs it traced live, and is
    torn down once none does or as one of them is freed. A session during
    which a step graph was freed ends with the teardown. Open: where
    another trainer's graphs were freed inside it, the next session traced
    no CUDA activity at all (`profiler_fault.py`'s (r5f'), (s1) and (s3);
    ROADMAP §3).

    A second fault is CUPTI's own: once a session has run, step graphs
    freed with no eager run of their model's forward under the profiler
    since (a second trainer's graphs, freed by `set_lr` and
    `free_graphs`) made a later session's first launch of another such
    graph die on a segmentation fault inside libcupti, called from
    `cuGraphLaunch`, reading address 0x113 in libcuda (`profiler_fault.py`
    on two H100s). It struck whether CUPTI was torn down or kept attached;
    it did not with no graph freed, with the conv's plain versions in the
    graphs, or with one session of eager train or eval steps before the
    frees. So `StepGraphs.drop` runs its trainer's eager eval forward under
    the profiler before it frees graphs (`traced_before_free`): inside the
    running session when there is one, else, once a session has ended, in
    a session of its own.

    That repair holds only where the port manages the teardown: with
    TEARDOWN_CUPTI set by the user (or by torch.compile, with
    DISABLE_CUPTI_LAZY_REINIT), CUPTI stays attached throughout, and a
    session of eager steps before the frees did not avert the fault. So
    once step graphs are freed in or after a session of this module while
    the variable is not the port's to set, every later session of this
    module raises a RuntimeError as it starts, before any launch in it
    (`release_cupti`); the variable itself is left as it is. A process
    with no session, or with no step graph freed in or after one, is never
    refused."""

    def start(self):
        if _cupti["refuse"] is not None:
            raise RuntimeError(_cupti["refuse"])
        _cupti["started"] = True
        self._owns_teardown = _sets_teardown()
        super().start()

    def stop(self):
        if self._owns_teardown and _sets_teardown():
            from matten_tpu_torch.train.graphs import live_graphs

            keep = live_graphs() > 0 and not _cupti["dropped"]
            _set_teardown("0" if keep else "1")
            _cupti.update(kept=keep, dropped=False)
        super().stop()


def release_cupti() -> None:
    """Tear down the CUPTI that a session left attached (`_Profile`), as
    `train.graphs.StepGraphs.drop` has freed a step graph; during a session,
    that session ends with the teardown. With it, a fit's order of events
    (a new pad shape captured after a session, `set_lr` freeing the train
    graphs while the eval graph lives) traced every session, the graphs
    that lived through it included (`chip_smoke.py::graph_probe`'s (f)).
    A free in or after a session of this module while TEARDOWN_CUPTI is
    not the port's to set refuses every later session (`_Profile`)."""
    if _cupti["started"] and not _sets_teardown():
        _cupti["refuse"] = _refusal()
    if torch.autograd._profiler_enabled():
        _cupti["dropped"] = True
        return
    if not _cupti["kept"]:
        return
    _cupti["kept"] = False
    if _sets_teardown():
        _set_teardown("1")
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        prof.stop()


def traced_before_free(forward: Callable[[], None]) -> None:
    """Run `forward`, an eager forward of the model whose step graphs are
    about to be freed, under the profiler: while a session runs, inside it,
    in a FREE_RANGE range of its trace; else, once a session of this module
    has ended having set TEARDOWN_CUPTI, inside a session of its own (CPU
    and CUDA activity, nothing written), which ends as the port last set
    the variable. Before any such session it runs nothing. The step
    graphs' repair of CUPTI's fault (`_Profile`): on a mesh every rank
    frees its graphs at the same point, so the forward's collectives
    meet."""
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(FREE_RANGE):
            _synchronized(forward)
        return
    if _cupti["wrote"] is None:
        return
    with torch.profiler.profile(activities=_activities()):
        _synchronized(forward)


def _synchronized(forward: Callable[[], None]) -> None:
    forward()
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _activities():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def profiler(activities=None) -> torch.profiler.profile:
    """A profiler of `activities` (CPU, and CUDA when a card is present),
    not started: a `torch.profiler.profile` that keeps CUPTI attached past
    its end while the step graphs it traced live (`_Profile`)."""
    return _Profile(activities=_activities() if activities is None else activities)


@contextlib.contextmanager
def profile_trace(logdir: str = "matten_tpu_trace"):
    """Profile the block with `torch.profiler` (`profiler()`: CPU, and CUDA
    when a card is present) and write its Chrome trace to
    `logdir/trace.json`. Sessions may follow one another in a process,
    around graph replays too (`_Profile`)."""
    os.makedirs(logdir, exist_ok=True)
    prof = profiler()
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ----------------------------------------------------------------------
# The tracer

# the span whose end advances the step index of the spans opened after it
STEP_SPAN = "fit.step"
# the step marks' pool (pairs): once it is full, the next step's start
# reads the marks first
STEP_POOL = 4096
# the most layer marks a step holds (a production train step makes about 55)
MARKS_PER_STEP = 512

_ON = False  # the switch: per-step spans, counters and marks only while it is on
_NOOP = contextlib.nullcontext()
_now = time.perf_counter_ns  # the host clock of spans and anchors


class DeviceClock:
    """The card's global nanosecond timer, as the tracer's marks read it:
    `buffer(n)` makes n slots, `stamp(buffer, i)` writes the timer into
    slot i on the current stream (a one-thread kernel: inside a CUDA graph
    capture, a kernel node), `sync()` waits for the stream, and
    `read(buffers)` gives each buffer's values as Python integers once the
    stream has passed them. A stand-in with the same four methods drives
    the tracer without a card."""

    def __init__(self):
        from matten_tpu_torch.kernels._build import load_library

        self.lib = load_library()

    def buffer(self, n: int) -> torch.Tensor:
        return torch.empty(n, dtype=torch.int64, device="cuda")

    def stamp(self, buffer: torch.Tensor, i: int) -> None:
        rc = self.lib.stamp(buffer.data_ptr() + 8 * i, torch.cuda.current_stream(buffer.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"stamp: kernel launch failed (cudaError {rc})")

    def sync(self) -> None:
        # an event's wait, which `torch.cuda.set_sync_debug_mode` does not report
        event = torch.cuda.Event()
        event.record()
        event.synchronize()

    def read(self, buffers: List[torch.Tensor]) -> List[List[int]]:
        host = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True) for b in buffers]
        for h, b in zip(host, buffers):
            h.copy_(b, non_blocking=True)
        self.sync()
        return [h.tolist() for h in host]


class SpanRecord(NamedTuple):
    """One span: `parent` the index of the enclosing span in
    `Record.spans` (-1 at the top), (`epoch`, `index`) the step it belongs
    to (`index`: the epoch's steps begun before it opened)."""

    name: str
    parent: int
    epoch: int
    index: int
    start_ns: int
    end_ns: int


class Read(NamedTuple):
    """The marks of one read (`read_marks`), on the host clock.

    `steps`: (kind, start ns, end ns, epoch, index) of each step's pair;
    `layer_ms`: {kind: {mark name: device ms}} over the steps that ran since
    the last read, a graph's last replay weighted by its replays and the
    last eager step of a kind by the eager steps of that kind;
    `layer_steps`: {kind: those steps}; `segments`: (mark name, start ns,
    end ns) of the layer segments of those last steps; `anchor_ns`: the host time of this read's anchor; `drift_ns`:
    the host's time between the last anchor (the tracer turning on, or the
    last read) and this one less the device's."""

    epoch: int
    steps: List[Tuple[str, int, int, int, int]]
    layer_ms: Dict[str, Dict[str, float]]
    layer_steps: Dict[str, int]
    segments: List[Tuple[str, int, int]]
    anchor_ns: int
    drift_ns: int


class Record(NamedTuple):
    """What the tracer holds: the spans, the counters and the reads."""

    spans: List[SpanRecord]
    counters: Dict[str, int]
    reads: List[Read]

    def seconds(self, name: str) -> float:
        """The seconds of every span of `name`."""
        return sum(s.end_ns - s.start_ns for s in self.spans if s.name == name) * 1e-9

    def self_seconds(self, name: str) -> float:
        """The seconds of every span of `name` less what their child spans cover."""
        child = defaultdict(int)
        for s in self.spans:
            if s.parent >= 0:
                child[s.parent] += s.end_ns - s.start_ns
        return sum(s.end_ns - s.start_ns - child[i] for i, s in enumerate(self.spans) if s.name == name) * 1e-9


class _Marks:
    """One step's layer marks: a slot of `buffer` at each boundary where the
    name changes (a mark that would not change it is not made), in order,
    the last named None (the step's end); `runs`, the steps since the last
    read whose last the slots hold (a graph's replays, or the eager steps
    of a kind)."""

    __slots__ = ("kind", "clock", "buffer", "names", "runs")

    def __init__(self, kind: str, clock):
        self.kind, self.clock, self.names, self.runs = kind, clock, [], 0
        self.buffer = clock.buffer(MARKS_PER_STEP)

    def add(self, name: Optional[str]) -> None:
        if (self.names and self.names[-1] == name) or len(self.names) == MARKS_PER_STEP:
            return
        self.clock.stamp(self.buffer, len(self.names))
        self.names.append(name)


class _Tracer:
    def __init__(self):
        self.spans: List[list] = []  # [name, parent, epoch, index, start, end]
        self.open: List[int] = []
        self.epoch, self.index = -1, 0
        self.counters: Counter = Counter()
        self.reads: List[Read] = []
        self.clock = None  # the device clock while marks are recorded
        self.pool = None  # the step marks' slots, STEP_POOL pairs
        self.used = 0  # pairs taken since the last read
        self.steps: list = []  # (kind, start slot, epoch, index) since the last read
        self.started = None  # the start slot of the step in progress
        self.current: Optional[_Marks] = None  # the layer marks of the step in progress
        self.captured: Optional[_Marks] = None  # the last step begun under a capture
        self.eager: Dict[str, _Marks] = {}  # the slots of the eager steps, by kind
        self.replayed: Dict[int, _Marks] = {}  # graphs replayed since the last read
        self.anchor = None  # (device ns, host ns)


_T = _Tracer()


class _Span:
    __slots__ = ("name", "i", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        t = _T
        self.i = len(t.spans)
        t.spans.append([self.name, t.open[-1] if t.open else -1, t.epoch, t.index, _now(), 0])
        t.open.append(self.i)
        self.rf = None
        if _ON and torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t = _T
        t.spans[self.i][5] = _now()
        t.open.pop()
        if self.name == STEP_SPAN:
            t.index += 1
        return False


def span(name: str, always: bool = False):
    """A span of `name` around the block: recorded while the tracer is on,
    or always with `always` (spans that open at most once an epoch or a
    step shape)."""
    if not (_ON or always):
        return _NOOP
    return _Span(name)


def epoch(n: int):
    """The always recorded span "fit.epoch" of epoch `n`: the spans opened
    inside it belong to epoch `n`, their index counting its steps."""
    _T.epoch, _T.index = n, 0
    return _Span("fit.epoch")


def enabled() -> bool:
    return _ON


def marks_on() -> bool:
    """Whether the tracer records device marks (on, with a device clock)."""
    return _T.clock is not None


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while the tracer is on."""
    if _ON:
        _T.counters[name] += n


def _anchor(extra=()) -> Tuple[Tuple[int, int], list]:
    """A mark, waited on, against the host clock: ((device ns, host ns), the
    values of the buffers `extra`)."""
    clock = _T.clock
    buffer = clock.buffer(1)
    clock.stamp(buffer, 0)
    clock.sync()
    host = _now()
    values = clock.read([buffer, *extra])
    return (values[0][0], host), values[1:]


def enable(clock=None, marks: bool = True) -> None:
    """Turn the tracer on. `clock` is the device clock of the marks
    (`DeviceClock`'s methods); by default the card's where there is one,
    else no mark is recorded; with `marks=False` none is (spans and
    counters only, the step graphs those of the tracer off). The step pool
    is made and the anchor taken here."""
    global _ON
    if not marks:
        clock = None
    elif clock is None and torch.cuda.is_available():
        clock = DeviceClock()
    _T.clock = clock
    _ON = True
    if clock is not None:
        _T.pool, _T.used = clock.buffer(2 * STEP_POOL), 0
        _T.anchor = _anchor()[0]


def disable() -> None:
    """Turn the tracer off; what it recorded stays (`record()`). Marks not
    read yet are dropped."""
    global _ON
    _ON = False
    _T.clock, _T.pool, _T.used, _T.steps, _T.anchor = None, None, 0, [], None
    _T.current = _T.captured = _T.started = None
    _T.eager, _T.replayed = {}, {}


@contextlib.contextmanager
def tracing(clock=None, marks: bool = True):
    """The tracer on inside the block (`enable`, `disable`)."""
    enable(clock, marks)
    try:
        yield
    finally:
        disable()


def clear() -> None:
    """Forget the spans, counters and reads recorded so far (outside every span)."""
    if _T.open:
        raise RuntimeError(f"clear() inside the open span {_T.spans[_T.open[-1]][0]!r}")
    _T.spans, _T.counters, _T.reads = [], Counter(), []


def record() -> Record:
    """The spans (those still open left out), counters and reads so far."""
    closed = [i for i, s in enumerate(_T.spans) if s[5]]
    at = {i: j for j, i in enumerate(closed)}
    spans = [SpanRecord(s[0], at.get(s[1], -1), *s[2:]) for s in (_T.spans[i] for i in closed)]
    return Record(spans, dict(_T.counters), list(_T.reads))


# ------------------------------------------------------------------ marks

class _GradMark(torch.autograd.Function):
    """The identity, whose backward marks the start of `bwd.<name>`: the
    gradient of a layer's output is complete, its own backward begins."""

    @staticmethod
    def forward(ctx, x, marks, name):
        ctx.marks, ctx.name = marks, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.marks.add("bwd." + ctx.name)
        return grad, None, None


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def begin_step(kind: str) -> None:
    """Start the layer marks of a step of `kind` ("train", "eval") while the
    tracer records marks. Begun under a CUDA graph capture, they are the
    graph's (`captured_marks`), read after its replays; else they go into
    the slots of the eager steps of `kind`, over the last one's."""
    if _T.clock is None:
        return
    if _capturing():
        marks = _T.captured = _Marks(kind, _T.clock)
    else:
        marks = _T.eager.get(kind)
        if marks is None:
            marks = _T.eager[kind] = _Marks(kind, _T.clock)
        marks.names = []
        marks.runs += 1
    _T.current = marks


def mark(name: str) -> None:
    """The device's time from here to the next mark of the step is `name`'s."""
    marks = _T.current
    if marks is not None:
        marks.add(name)


def grad_mark(x: torch.Tensor, name: str) -> torch.Tensor:
    """`x`, the output of the layer `name`, through an identity whose
    backward marks the start of `bwd.<name>` (while a step's marks are
    recorded and `x` takes a gradient; else `x` itself)."""
    marks = _T.current
    if marks is None or not x.requires_grad:
        return x
    return _GradMark.apply(x, marks, name)


def marking() -> bool:
    """Whether a step's layer marks are being recorded."""
    return _T.current is not None


def end_step() -> None:
    """The step's last mark: its end."""
    marks = _T.current
    if marks is not None:
        marks.add(None)
        _T.current = None


def captured_marks() -> Optional[_Marks]:
    """The layer marks of the step just captured (None with the tracer off)."""
    marks, _T.captured = _T.captured, None
    return marks


def replayed(marks: Optional[_Marks]) -> None:
    """A replay of the graph whose capture made `marks`."""
    if marks is not None:
        _T.replayed[id(marks)] = marks
        marks.runs += 1


def step_start(kind: str):
    """Mark the start of a step of `kind` on the current stream (once the
    pool is full, after a read of the marks: a wait for the card); returns
    what `step_end` takes (None while no mark is recorded)."""
    if _T.clock is None:
        return None
    if _T.used == STEP_POOL:
        read_marks()
    slot = 2 * _T.used
    _T.used += 1
    _T.clock.stamp(_T.pool, slot)
    _T.started = slot
    return kind, slot


def step_launch() -> None:
    """Mark the step's start again, as a graph is launched once its static
    inputs are copied in: those copies are host-paced (a call per field),
    and inside the step's pair the device's wait for them would count as
    the step's."""
    if _T.started is not None:
        _T.clock.stamp(_T.pool, _T.started)


def step_end(started) -> None:
    if started is not None:
        kind, slot = started
        _T.clock.stamp(_T.pool, slot + 1)
        _T.steps.append((kind, slot, _T.epoch, _T.index))
        _T.started = None


def read_marks() -> None:
    """Read the marks made since the last read, once the device has run
    them (after the fit loop's epoch-end sync, or as a step starts once the
    pool is full): a span "trace.read", a new anchor, and a `Read` in the
    record."""
    if _T.clock is None:
        return
    with span("trace.read"):
        marked = [m for m in (*_T.eager.values(), *_T.replayed.values()) if m.runs]
        (device, host), values = _anchor([_T.pool[:2 * _T.used]] + [m.buffer for m in marked])
        pool, layers = values[0], values[1:]

        def at(ns: int) -> int:
            return host - (device - ns)

        steps = [(kind, at(pool[i]), at(pool[i + 1]), ep, ix) for kind, i, ep, ix in _T.steps]
        layer_ms: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        layer_steps: Dict[str, int] = defaultdict(int)
        segments = []
        for marks, ns in zip(marked, layers):
            layer_steps[marks.kind] += marks.runs
            for name, t0, t1 in zip(marks.names, ns, ns[1:len(marks.names)]):
                layer_ms[marks.kind][name] += (t1 - t0) * 1e-6 * marks.runs
                segments.append((name, at(t0), at(t1)))
            marks.runs = 0
        old_device, old_host = _T.anchor
        drift = host - old_host - (device - old_device)
        _T.reads.append(Read(_T.epoch, steps, {k: dict(v) for k, v in layer_ms.items()}, dict(layer_steps),
                             segments, host, drift))
        _T.anchor = device, host
        _T.used, _T.steps, _T.replayed = 0, [], {}


def export_chrome_trace(path: str) -> None:
    """Write the spans (host ranges, category "user_annotation") and the
    reads' marks (step pairs as device ranges, category "kernel", named
    "step.<kind>"; layer segments as "gpu_user_annotation" ranges) as a
    Chrome trace, in microseconds of `perf_counter_ns`."""
    rec = record()
    events = [{"ph": "X", "cat": "user_annotation", "name": s.name, "pid": 0, "tid": 0, "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3, "args": {"epoch": s.epoch, "step": s.index}}
              for s in rec.spans]
    for read in rec.reads:
        events += [{"ph": "X", "cat": "kernel", "name": f"step.{kind}", "pid": 1, "tid": 0, "ts": a / 1e3,
                    "dur": (b - a) / 1e3, "args": {"epoch": ep, "step": ix}} for kind, a, b, ep, ix in read.steps]
        events += [{"ph": "X", "cat": "gpu_user_annotation", "name": name, "pid": 1, "tid": 1, "ts": a / 1e3,
                    "dur": (b - a) / 1e3} for name, a, b in read.segments]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
