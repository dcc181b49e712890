"""Steps replayed as CUDA graphs, one per batch shape.

Counterpart of the JAX package's compiled steps: `jax.jit` compiles the
trainer's `_train_step_impl` and `_eval_step_impl` (under `shard_map` on a
mesh) once per padded batch shape, and runs every later call of that shape
as one dispatch. Here a call of a shape seen
before is one `cudaGraphLaunch` of the kernels its eager run launched, in
place of the ~2000 launches the host would make again.

`StepGraphs.run(kind, data, targets)` runs one of its step functions, each
a function of `(data, targets)` that returns a tensor or a flat tuple of
tensors: the trainer's train and eval steps, or a forward. It
keys a call by the kind, the conv's global settings (the tier, the storage
dtype of sh and w, a forced shared-memory limit), the mesh's shape and mode
when the batch carries one (`parallel.MESH`: a graph holds the collectives
of its mesh's groups) and `batch_key`, the JAX fit loop's key of a batch.
The first sight of a key runs the real step eagerly, which is the warm-up
(the kernels built, the tables and the optimizer state allocated, and on a
mesh the NCCL communicators created, the point-to-point one of the ring
shift included); the second captures the step into a graph with its own
memory pool and replays it; every later sight replays it. So no extra step
is taken: every call is one real step. A replay copies the batch into the
graph's static inputs (device-to-device, no host sync), launches the graph
and returns a copy of the step's outputs, which the next replay
overwrites; while the tracer (`utils.timing`) is on it also adds to the
kernel launch counters of `kernels.fused_conv` what the capture launched.
A capture that fails raises; nothing falls back to the eager step.

With the tracer recording device marks, a key's graph is another
(`utils.timing.marks_on` is part of the key): its capture bakes the
model's layer marks into it, as kernel nodes
(`utils.timing.DeviceClock`); with the tracer on without marks, the
graphs are those of the tracer off. A first sight, a capture and a drop
are spans of the tracer ("graphs.first_sight", "graphs.capture",
"graphs.drop", recorded whether it is on or not); a replay is one
("graphs.replay") while it is on, with the counter "graphs.replays".

A capture records the NCCL collectives of a mesh step (all-reduces,
all-gathers and the ring's sends and receives) with the kernels around
them; the ranks capture and replay the same sequence, since their blocks
share one shape. It runs in the "thread_local" capture mode, so the
process group's watchdog thread, which queries events of earlier eager
collectives, does not invalidate it. gloo's collectives run on the host
and cannot be captured: such a mesh is not given graphs
(`parallel.captures_collectives`). A replayed collective is not watched by
the group's timeout: a rank that dies leaves the others waiting until
their launcher ends the world. A graph that captured NCCL operations holds
its communicators: NCCL destroys a communicator only once every such graph
is gone, so the graphs are freed (`drop()`, `Trainer.free_graphs`) before
the process group is destroyed, never left to the garbage collector
(`live_graphs()` counts those not yet freed; `parallel.launch` refuses to
destroy a rank's group while any is).

What a replay reads is what the capture saw: the parameters, buffers and
optimizer state tensors (updated in place), the learning rate of each
param group (a float, baked into the graph), and the gradients, which the
captured backward writes into the graph's pool. So `drop("train")` must
follow anything that changes the learning rate or replaces the optimizer's
state tensors (`Trainer.set_lr`, `Trainer.load_state_dict`); the next step
of a key seen before captures anew. The eval and forward graphs read only
the model, whose `load_state_dict` copies in place.

Under `utils.timing.profile_trace` a replay is traced like eager steps;
the port's profiler keeps CUPTI attached between sessions while the
graphs it traced live, and `drop` tears it down once it has freed any.
`drop` first runs the owner's eager forward (`forward`, the trainer's
eval step) on a freed graph's inputs under the profiler: inside the
running session, in a range of its own, or, once a session has ended, in
a session of its own. Without it, a later session's launch of another
step graph died on a segmentation fault inside CUPTI; where the user has
set TEARDOWN_CUPTI, later sessions are refused instead
(`utils.timing._Profile` says why).

Python's garbage collector is off while a step is captured: a collection
that fell inside a capture (moved there by the allocations before it) made
the capture fail with cudaErrorStreamCaptureInvalidated on an H100.
"""

from __future__ import annotations

import gc
import weakref
from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from matten_tpu_torch.kernels import fused_conv, fused_tp
from matten_tpu_torch.parallel.sharding import MESH
from matten_tpu_torch.utils.anomaly import DetectAnomaly
from matten_tpu_torch.utils import timing
from matten_tpu_torch.utils.timing import release_cupti, traced_before_free

__all__ = ["StepGraphs", "batch_key", "can_capture", "live_graphs"]

# the launch counters of kernels/fused_conv.py (each kernel's count) and,
# beside them, its `tier_launches` Counter
COUNTERS = ("launches", "fwd_sum_launches", "bwd_launches", "dx_sum_launches", "bf16_launches",
            "bf16_bwd_launches")

Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

# every captured step not yet freed (`live_graphs`)
_LIVE: "weakref.WeakSet[_Captured]" = weakref.WeakSet()


def batch_key(data: Dict[str, Any], targets: Dict[str, Any]) -> Tuple:
    """The JAX fit loop's key of a batch: the sorted (name, shape) of every
    data and target field, with its dtype; entries without a shape (an
    edge plan a forward stored, the mesh) are not fields."""
    return tuple(
        tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in part.items() if hasattr(v, "shape")))
        for part in (data, targets)
    )


def can_capture(model: torch.nn.Module, device: torch.device) -> bool:
    """Whether a step of `model` on `device` can be captured: on the card,
    and built without DEBUG anomaly layers, whose checks read every layer's
    output back on the host."""
    return device.type == "cuda" and not any(isinstance(m, DetectAnomaly) for m in model.modules())


def live_graphs() -> int:
    """How many captured steps of this process are not yet freed."""
    return len(_LIVE)


def _counts() -> Tuple[Dict[str, int], Counter]:
    return {c: getattr(fused_conv, c) for c in COUNTERS}, Counter(fused_conv.tier_launches)


def _set_counts(counts: Dict[str, int], tiers: Counter) -> None:
    for c, v in counts.items():
        setattr(fused_conv, c, v)
    fused_conv.tier_launches.clear()
    fused_conv.tier_launches.update(tiers)


class _Captured:
    """One captured step: its graph, static inputs and outputs, the
    launches its capture made, and its layer marks while the tracer is on."""

    def __init__(self, step: Callable[[Dict, Dict], Outputs], data: Dict, targets: Dict):
        # the batch's other entries (the mesh) go into the static dict as they are
        self.data = {k: v.clone() if torch.is_tensor(v) else v for k, v in data.items()}
        self.targets = {k: v.clone() for k, v in targets.items()}
        # (static input, batch dict, field): the capture's forward may add
        # its edge plan to the static data dict, which is no input
        self.inputs = [(v, i, k) for i, part in enumerate((self.data, self.targets))
                       for k, v in part.items() if torch.is_tensor(v)]
        self.graph = torch.cuda.CUDAGraph()
        before = _counts()
        # no garbage collection inside the capture (`torch.cuda.graph` runs
        # one before it): one that fell inside a capture made it fail
        collecting = gc.isenabled()
        gc.disable()
        try:
            # the graph's own memory pool: nothing else allocates from it
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                out = step(self.data, self.targets)
                self.single = torch.is_tensor(out)
                self.out = (out,) if self.single else tuple(out)
        finally:
            if collecting:
                gc.enable()
            after = _counts()
            _set_counts(*before)
        self.marks = timing.captured_marks()
        _LIVE.add(self)
        self.launches = {c: after[0][c] - before[0][c] for c in COUNTERS}
        self.tier_launches = after[1] - before[1]

    def replay(self, data: Dict, targets: Dict) -> Outputs:
        with timing.span("graphs.replay"):
            batch = (data, targets)
            for v, i, k in self.inputs:
                v.copy_(batch[i][k], non_blocking=True)
            timing.step_launch()
            self.graph.replay()
            if timing.enabled():
                self._count()
            out = tuple(x.clone() for x in self.out)
        return out[0] if self.single else out

    def _count(self) -> None:
        """A replay in the tracer's counter and marks, and its launches in
        the counters of `kernels.fused_conv`."""
        timing.replayed(self.marks)
        timing.count("graphs.replays")
        for c, n in self.launches.items():
            setattr(fused_conv, c, getattr(fused_conv, c) + n)
        fused_conv.tier_launches.update(self.tier_launches)

    def pool_bytes(self) -> int:
        """Bytes of the device memory segments of the graph's pool."""
        pool = self.graph.pool()
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(pool))


class StepGraphs:
    """The captured steps of one trainer. `steps` maps each kind to its
    eager step, `(data, targets) -> tensor or flat tuple of tensors`, and
    `prepare`, if given, runs before each replay (the model's train or eval
    mode, which the graph does not set). `forward`, if given, is an eager
    step with no effect on the trainer's state (its eval forward, which
    leaves the model's mode as it was), which `drop` runs on a freed
    graph's inputs under the profiler (`utils.timing.traced_before_free`)."""

    def __init__(self, steps: Dict[str, Callable[[Dict, Dict], Outputs]],
                 prepare: Optional[Callable[[str], None]] = None,
                 forward: Optional[Callable[[Dict, Dict], object]] = None):
        self.steps = steps
        self.prepare = prepare
        self.forward = forward
        self.seen = set()
        self.graphs: Dict[Tuple, _Captured] = {}

    def key(self, kind: str, data: Dict, targets: Dict) -> Tuple:
        """(kind, the conv's tier settings, the mesh's (n_data, n_graph,
        mode) or None, whether the tracer records marks, `batch_key`)."""
        mesh = data.get(MESH)
        return (kind, fused_tp.get_tp_impl(), fused_tp.get_kernel_in_dtype(), fused_conv._smem_cap,
                None if mesh is None else (mesh.n_data, mesh.n_graph, mesh.mode), timing.marks_on(),
                batch_key(data, targets))

    def run(self, kind: str, data: Dict, targets: Dict) -> Outputs:
        key = self.key(kind, data, targets)
        captured = self.graphs.get(key)
        if captured is None:
            if key not in self.seen:
                self.seen.add(key)
                with timing.span("graphs.first_sight", always=True):
                    return self.steps[kind](data, targets)
            with timing.span("graphs.capture", always=True):
                captured = self.graphs[key] = _Captured(self.steps[kind], data, targets)
        if self.prepare is not None:
            self.prepare(kind)
        return captured.replay(data, targets)

    def drop(self, kind: Optional[str] = None) -> None:
        """Free the graphs of `kind` (every graph with None); the next step
        of each key seen before captures anew. `forward` first runs on the
        first freed graph's inputs under the profiler, inside the running
        session or, once a session has ended, in a session of its own
        (`utils.timing.traced_before_free`; its launches are not counted, as
        a capture's are not); once they are freed, a CUPTI that a session
        left attached is torn down (`utils.timing.release_cupti`). On a mesh
        every rank drops the same graphs at the same point of its steps, as
        every rank steps."""
        kept = {k: g for k, g in self.graphs.items() if kind is not None and k[0] != kind}
        freed = [g for k, g in self.graphs.items() if k not in kept]
        if not freed:
            return
        with timing.span("graphs.drop", always=True):
            if self.forward is not None:
                counts = _counts()
                first = freed[0]
                traced_before_free(lambda: self.forward(first.data, first.targets))
                _set_counts(*counts)
                del first
            self.graphs = kept
            del freed  # the last references: the graphs are freed here
            release_cupti()

    def pool_bytes(self) -> int:
        """Bytes held by the pools of every graph."""
        return sum(g.pool_bytes() for g in self.graphs.values())
