"""Reading a `torch.profiler` Chrome trace: the device's busy union, device
time by kernel name, graph launches, and the host's activity in the
device's idle gaps. Copied from `chip_smoke.py` (`trace_events`,
`trace_stats`, `is_kind`), which stays as it is."""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["DEVICE_OPS", "HOST_CATS", "trace_events", "Trace"]

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that say what the host was doing
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
# idle gaps labelled by the host event under their midpoint: the longest this many
LABELLED_GAPS = 4000


def trace_events(path: Path) -> List[dict]:
    """The complete ("X") events of a Chrome trace file."""
    ev = json.loads(Path(path).read_text())
    return [e for e in (ev["traceEvents"] if isinstance(ev, dict) else ev) if e.get("ph") == "X"]


class Trace:
    """The device operations and host events of one traced span. Times in
    seconds; `gpu_user_annotation` ranges, which span kernels on the
    device side, are kept out of every device sum."""

    def __init__(self, events: Sequence[dict]):
        dev = sorted((e for e in events if e.get("cat") in DEVICE_OPS), key=lambda e: e["ts"])
        self.device = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6) for e in dev]
        self.host = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6) for e in events if e.get("cat") in HOST_CATS]
        self.graph_launches = sum(e.get("cat") == "cuda_runtime" and e["name"].startswith("cudaGraphLaunch")
                                  for e in events)
        self.busy_s, self._gaps = self._union()

    def _union(self) -> Tuple[float, List[Tuple[float, float]]]:
        """(seconds in which some device operation ran, the idle gaps
        between the first and the last as (start, length))."""
        busy, end, gaps = 0.0, None, []
        for _, s, d in self.device:
            t = s + d
            if end is not None and s > end:
                gaps.append((end, s - end))
            busy += t - s if end is None else max(0.0, t - max(s, end))
            end = t if end is None else max(end, t)
        return busy, gaps

    def seconds(self, *parts: str) -> float:
        """Device seconds of the kernels whose name holds every part."""
        return sum(d for n, _, d in self.device if all(p in n for p in parts))

    def top_ops(self, k: int = 10) -> List[List]:
        """The k device operations by name that took the most seconds."""
        by = defaultdict(float)
        for n, _, d in self.device:
            by[n] += d
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The device's idle time by what the host was doing: the longest
        gaps, each labelled by the innermost host event over its midpoint
        ("no host event" where none is), summed by label; the k largest."""
        if not self._gaps:
            return []
        gaps = sorted(self._gaps, key=lambda g: -g[1])[:LABELLED_GAPS]
        names = [n for n, _, _ in self.host]
        start = np.array([s for _, s, _ in self.host]) if self.host else np.zeros(0)
        dur = np.array([d for _, _, d in self.host]) if self.host else np.zeros(0)
        by = defaultdict(float)
        for s, d in gaps:
            mid = s + d / 2
            cover = np.nonzero((start <= mid) & (start + dur >= mid))[0]
            label = names[cover[np.argmin(dur[cover])]] if cover.size else "no host event"
            by[label] += d
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]
