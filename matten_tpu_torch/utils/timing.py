"""Timing and profiling: per-epoch wall time, a synchronized step timer
with an edges/s counter, and profiler traces.

Counterpart of `matten_tpu/utils/timing.py`: the step timer waits for the
device of the result it is given (`torch.cuda.synchronize`, where JAX uses
`block_until_ready`), and `profile_trace` writes a `torch.profiler` trace
(Chrome trace JSON, with CUDA activity when a card is present) in place of
the jax profiler's. Every session is a `profiler()`, which keeps CUPTI
attached between sessions while the step graphs it traced live, and
`release_cupti` tears it down as one of them is freed, so that the card's
step graphs, those that hold NCCL collectives included, are traced in
sessions in turn. `traced_before_free` runs an eager forward under the
profiler before step graphs are freed, inside the running session or,
once a session has ended, in one of its own, without which a later
session's graph launch faulted in CUPTI. Where the user (or
torch.compile) has set TEARDOWN_CUPTI, that repair does not hold: once
step graphs are freed in or after a session, later sessions are refused
with a RuntimeError (`_Profile`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

__all__ = ["FREE_RANGE", "TimeMeter", "StepTimer", "profiler", "profile_trace", "release_cupti",
           "traced_before_free"]


class TimeMeter:
    """Epoch wall-time deltas + cumulative time."""

    def __init__(self, frequency: int = 1):
        self.frequency = frequency
        self.t0 = time.time()
        self.t_last = self.t0

    def update(self) -> tuple:
        now = time.time()
        delta = now - self.t_last
        cumulative = now - self.t0
        self.t_last = now
        return delta, cumulative


def _block(result) -> None:
    """Wait for the card behind every CUDA tensor of `result` (a tensor, or
    a dict / list / tuple of them)."""
    if torch.is_tensor(result):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _block(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _block(v)


class StepTimer:
    """Synchronized step timing with an edges/s throughput counter."""

    def __init__(self):
        self.steps = 0
        self.edges = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def step(self, result_to_block=None, num_edges: int = 0):
        """Time the block; with `result_to_block` (the step's output, or a
        container of it) the time runs until its device has finished."""
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            _block(result_to_block)
        self.seconds += time.perf_counter() - t0
        self.steps += 1
        self.edges += num_edges

    @property
    def edges_per_s(self) -> float:
        return self.edges / self.seconds if self.seconds > 0 else 0.0


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
