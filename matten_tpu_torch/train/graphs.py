"""Train and eval steps replayed as CUDA graphs, one per batch shape.

Counterpart of the JAX trainer's compiled steps: `jax.jit` compiles
`_train_step_impl` and `_eval_step_impl` once per padded batch shape and
runs every later step of that shape as one dispatch. Here a step of a
shape seen before is one `cudaGraphLaunch` of the kernels its eager run
launched, in place of the ~2000 launches the host would make again.

`StepGraphs.run(kind, data, targets)` keys a step by its kind ("train" or
"eval"), the conv's global settings (the tier, the storage dtype of sh and
w, a forced shared-memory limit) and `batch_key`, the JAX fit loop's key
of a batch. The first sight of a key runs the real step eagerly, which is
the warm-up (the kernels built, the tables and the optimizer state
allocated); the second captures the step into a graph with its own memory
pool and replays it; every later sight replays it. So no extra step is
taken: every call is one real step. A replay copies the batch into the
graph's static inputs (device-to-device, no host sync), launches the
graph, adds to the kernel launch counters of `kernels.fused_conv` what the
capture launched, and returns a copy of the step's outputs, which the next
replay overwrites. A capture that fails raises; nothing falls back to the
eager step.

What a replay reads is what the capture saw: the parameters, buffers and
optimizer state tensors (updated in place), the learning rate of each
param group (a float, baked into the graph), and the gradients, which the
captured backward writes into the graph's pool. So `drop("train")` must
follow anything that changes the learning rate or replaces the optimizer's
state tensors (`Trainer.set_lr`, `Trainer.load_state_dict`); the next step
of a key seen before captures anew. The eval graphs read only the model,
whose `load_state_dict` copies in place.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, Dict, Tuple

import torch

from matten_tpu_torch.kernels import fused_conv, fused_tp

__all__ = ["StepGraphs", "batch_key"]

# the launch counters of kernels/fused_conv.py (each kernel's count) and,
# beside them, its `tier_launches` Counter
COUNTERS = ("launches", "fwd_sum_launches", "bwd_launches", "dx_sum_launches", "bf16_launches",
            "bf16_bwd_launches")


def batch_key(data: Dict[str, Any], targets: Dict[str, Any]) -> Tuple:
    """The JAX fit loop's key of a batch: the sorted (name, shape) of every
    data and target field, with its dtype; entries without a shape (an
    edge plan a forward stored) are not fields."""
    return tuple(
        tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in part.items() if hasattr(v, "shape")))
        for part in (data, targets)
    )


def _counts() -> Tuple[Dict[str, int], Counter]:
    return {c: getattr(fused_conv, c) for c in COUNTERS}, Counter(fused_conv.tier_launches)


def _set_counts(counts: Dict[str, int], tiers: Counter) -> None:
    for c, v in counts.items():
        setattr(fused_conv, c, v)
    fused_conv.tier_launches.clear()
    fused_conv.tier_launches.update(tiers)


class _Captured:
    """One captured step: its graph, static inputs and outputs, and the
    launches its capture made."""

    def __init__(self, step: Callable, data: Dict, targets: Dict):
        self.data = {k: v.clone() for k, v in data.items() if torch.is_tensor(v)}
        self.targets = {k: v.clone() for k, v in targets.items()}
        # (static input, batch dict, field): the capture's forward adds its
        # edge plan to the static data dict, which is no input
        self.inputs = [(v, i, k) for i, part in enumerate((self.data, self.targets)) for k, v in part.items()]
        self.graph = torch.cuda.CUDAGraph()
        before = _counts()
        t0 = time.perf_counter()
        try:
            # the graph's own memory pool: nothing else allocates from it
            with torch.cuda.graph(self.graph):
                loss, sums = step(self.data, self.targets)
                self.names = list(sums)
                self.out = torch.stack([loss] + [x for n in self.names for x in sums[n]])
        finally:
            after = _counts()
            _set_counts(*before)
        self.capture_s = time.perf_counter() - t0
        self.launches = {c: after[0][c] - before[0][c] for c in COUNTERS}
        self.tier_launches = after[1] - before[1]

    def replay(self, data: Dict, targets: Dict) -> Tuple[torch.Tensor, Dict]:
        batch = (data, targets)
        for v, i, k in self.inputs:
            v.copy_(batch[i][k], non_blocking=True)
        self.graph.replay()
        counts, tiers = _counts()
        _set_counts({c: counts[c] + self.launches[c] for c in COUNTERS}, tiers + self.tier_launches)
        out = self.out.clone()
        return out[0], {n: (out[1 + 2 * i], out[2 + 2 * i]) for i, n in enumerate(self.names)}

    def pool_bytes(self) -> int:
        """Bytes of the device memory segments of the graph's pool."""
        pool = self.graph.pool()
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(pool))


class StepGraphs:
    """The captured train and eval steps of one trainer. `steps` maps each
    kind to its eager step, `(data, targets) -> (loss, {task: (sum,
    count)})`, and `prepare` runs before each replay (the model's train or
    eval mode, which the graph does not set)."""

    def __init__(self, steps: Dict[str, Callable], prepare: Callable[[str], None]):
        self.steps = steps
        self.prepare = prepare
        self.seen = set()
        self.graphs: Dict[Tuple, _Captured] = {}

    def run(self, kind: str, data: Dict, targets: Dict) -> Tuple[torch.Tensor, Dict]:
        key = (kind, fused_tp.get_tp_impl(), fused_tp.get_kernel_in_dtype(), fused_conv._smem_cap,
               batch_key(data, targets))
        captured = self.graphs.get(key)
        if captured is None:
            if key not in self.seen:
                self.seen.add(key)
                return self.steps[kind](data, targets)
            captured = self.graphs[key] = _Captured(self.steps[kind], data, targets)
        self.prepare(kind)
        return captured.replay(data, targets)

    def drop(self, kind: str) -> None:
        """Forget the graphs of `kind`; the next step of each key seen
        before captures anew."""
        self.graphs = {k: g for k, g in self.graphs.items() if k[0] != kind}

    def capture_seconds(self) -> Dict[Tuple, float]:
        return {k: g.capture_s for k, g in self.graphs.items()}

    def pool_bytes(self) -> int:
        """Bytes held by the pools of every graph."""
        return sum(g.pool_bytes() for g in self.graphs.values())
