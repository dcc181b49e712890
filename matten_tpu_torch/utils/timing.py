"""Timing and profiling: per-epoch wall time, a synchronized step timer
with an edges/s counter, and profiler traces.

Counterpart of `matten_tpu/utils/timing.py`: the step timer waits for the
device of the result it is given (`torch.cuda.synchronize`, where JAX uses
`block_until_ready`), and `profile_trace` writes a `torch.profiler` trace
(Chrome trace JSON, with CUDA activity when a card is present) in place of
the jax profiler's.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["TimeMeter", "StepTimer", "profile_trace"]


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


@contextlib.contextmanager
def profile_trace(logdir: str = "matten_tpu_trace"):
    """Profile the block with `torch.profiler` (CPU, and CUDA when a card is
    present) and write its Chrome trace to `logdir/trace.json`."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
