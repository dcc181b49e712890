"""One run of one cell: set-up, the measured window or the traced span,
then the comparison that decides `correct`.

Everything that belongs to one configuration, mix or per-layer metric is
a file found by its name in `BENCHMARK.json`: `configs/<config>.json`,
`traffic/<traffic>.json` (read by `traffic.py`, the one generator) and
`metrics/<base>.py` (a reader with `read(span) -> float or None`), where
`<base>` is the metric's name up to its first dot: the part after it
names the end-to-end metric that it moves, so twins of one quantity in
cells of different rates share a reader. An end-to-end metric is the
quantity of its base name that `_window` measures, reported in the cells
that its `workloads` lists, or in every cell without that key.

Set-up, in the order a user's train script takes it, through the port's
public entry points: the dataset files drawn from the seed and read by
the port's `TensorDataModule` (graphs, statistics, target normalisation),
the model built by the port's factory and given the benchmark's weights
(`weights.py`), its `Trainer`; then one `Trainer.fit` epoch of the
compared steps (`correctness.py`: three train batches at the largest
shape of the train loader's ladder, three validation batches at the
largest of the validation loader's); then one `fit` epoch of two train
batches at each other shape of the train ladder and two validation
batches at each other shape of the validation ladder (at each shape the
first step runs eagerly, the second captures its CUDA graph); then the
mix's warm-up epochs. No shape is new to the window.

The window (`--trace 0`) is whole `Trainer.fit` epochs of the same
trainer: train steps, validation, the plateau scheduler, the epoch-end
reads. It ends at the first epoch boundary past `--seconds`, where the
epoch's validation loader runs dry, through the trainer's own early
stop. The traced run (`--trace 1`) times the mix's `timed_epochs` whole
epochs untraced, then profiles `traced_epochs` whole epochs with the
port's `utils.timing.profiler()`, and reads the per-layer metrics: the
device's times and counts from the trace, the host's shares from the
untraced epochs, which the profiler does not slow.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import correctness, traffic
from benchmark.weights import make_weights

BENCH = Path(__file__).resolve().parent

__all__ = ["load", "Program", "run_cell"]


def load(kind: str, name: str) -> Dict[str, Any]:
    """A configuration ("configs") or mix ("traffic") by its name."""
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def base(name: str) -> str:
    """A metric's name up to its first dot."""
    return name.split(".")[0]


def metric_reader(name: str) -> Callable:
    """`read` of `metrics/<base of name>.py`."""
    path = BENCH / "metrics" / f"{base(name)}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{base(name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Batches:
    """A loader handed to `fit`: each `next()` timed in a span of its own
    ("loader.<split>", also a profiler range), each batch's real crystals,
    nodes and edges counted; `on_end` runs when it runs dry."""

    def __init__(self, inner, split: str, log: Dict[str, list], on_end: Optional[Callable] = None):
        self.inner, self.split, self.log, self.on_end = inner, split, log, on_end

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self):
        it = iter(self.inner)
        label = f"loader.{self.split}"
        while True:
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                batch = next(it, None)
            if batch is None:
                break
            data = batch[0]
            self.log[self.split].append((int(np.sum(data["graph_mask"])), int(np.sum(data["node_mask"])),
                                         int(np.sum(data["edge_mask"])), time.perf_counter() - t0))
            yield batch
        if self.on_end is not None:
            self.on_end()


class Epochs:
    """The data module handed to `fit`: the port's loaders wrapped in
    `Batches`; after each epoch's validation, `stop()` decides whether that
    epoch is the last, through the trainer's own early stop."""

    def __init__(self, dm, trainer, stop: Callable[[int], bool]):
        self.dm, self.trainer, self.stop = dm, trainer, stop
        self.epochs = 0
        self.log: Dict[str, list] = {"train": [], "val": []}

    def _end(self) -> None:
        self.epochs += 1
        if self.stop(self.epochs):
            self.trainer.config.early_stopping_patience = -1

    def train_dataloader(self):
        return Batches(self.dm.train_dataloader(), "train", self.log)

    def val_dataloader(self):
        return Batches(self.dm.val_dataloader(), "val", self.log, self._end)


def fit_epochs(trainer, dm, stop: Callable[[int], bool]) -> Epochs:
    """`trainer.fit` over `dm` until `stop(epochs done)` at an epoch's end."""
    cfg = trainer.config
    saved = cfg.max_epochs, cfg.early_stopping_patience
    cfg.max_epochs = 1 << 30
    epochs = Epochs(dm, trainer, stop)
    try:
        trainer.fit(epochs)
    finally:
        cfg.max_epochs, cfg.early_stopping_patience = saved
    return epochs


class Fixed:
    """A data module of given batches for one `fit` epoch: its train loader
    yields `train`, its validation loader `val`."""

    def __init__(self, train: list, val: list):
        self.train, self.val = train, val

    def train_dataloader(self):
        return list(self.train)

    def val_dataloader(self):
        return list(self.val)


def fit_once(trainer, train: list, val: list) -> None:
    """One `trainer.fit` epoch over the given train and validation batches;
    the plateau scheduler is left as it was, so that the first epoch it
    sees is the warm-up's, as in a user's run."""
    cfg = trainer.config
    saved = cfg.max_epochs, copy.deepcopy(trainer.scheduler)
    cfg.max_epochs = 1
    try:
        trainer.fit(Fixed(train, val))
    finally:
        cfg.max_epochs, trainer.scheduler = saved


class Program:
    """The port's side of a run: the data module, the model with the
    benchmark's weights, the trainer, and the readings of its compared
    steps (`correctness.py`)."""

    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any], seed: int, device: torch.device,
                 workdir: Path):
        from matten_tpu_torch.data.datamodule import TensorDataModule
        from matten_tpu_torch.models.tfn import create_atomic_tensor_model, create_scalar_tensor_model
        from matten_tpu_torch.train import CanonicalRegressionTask, Trainer
        from matten_tpu_torch.train.trainer import TrainerConfig

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        rows = traffic.draw_rows(mix, config, seed)
        self.files = {split: traffic.write_split(r, workdir / f"{split}.json") for split, r in rows.items()}
        data = {k: v for k, v in config["data"].items() if k != "loader_kwargs"}
        self.dm = TensorDataModule(str(self.files["train"]), str(self.files["val"]), str(self.files["val"]),
                                   root=str(workdir), reuse=False, seed=seed,
                                   loader_kwargs=config["data"]["loader_kwargs"], **data)
        self.dm.setup()
        self.loaders = {"train": self.dm.train_dataloader(), "val": self.dm.val_dataloader()}
        per_atom = config["family"] == "atomic"
        create = create_atomic_tensor_model if per_atom else create_scalar_tensor_model
        model = create(dict(config["model"]), self.dm.get_to_model_info(), device=device, seed=0)
        self.weights = make_weights(((n, p.shape) for n, p in model.named_parameters()), seed, device)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(self.weights[n])
        name = config["data"]["tensor_target_name"]
        normalizer = self.dm.statistics.target_normalizer if config["data"].get("normalize_tensor_target") else None
        task = CanonicalRegressionTask(name=name, per_atom=per_atom, normalizer=normalizer)
        fields = set(TrainerConfig.__dataclass_fields__)
        self.trainer = Trainer(model, [task], TrainerConfig(**{k: v for k, v in config["trainer"].items()
                                                               if k in fields}, seed=seed), device=device)
        self.first = correctness.ProgramReadings(self.trainer)
        self.rows = self._first_steps()

    def _collate(self, split: str, graphs: list, pad) -> tuple:
        from matten_tpu_torch.data.graph import collate_graphs

        return collate_graphs(graphs, pad, species_map=self.loaders[split].species_map)

    def _first_steps(self) -> Dict[str, List[List[int]]]:
        """One `fit` epoch of the compared steps (module docstring); returns
        each split's rows of the file, one list per batch."""
        batches, rows = {}, {}
        for split, loader in self.loaders.items():
            size = loader.batch_size
            failed = set(self.dm.failed[split])
            row_of = [r for r in range(len(loader.graphs) + len(failed)) if r not in failed]
            if len(loader.graphs) < correctness.STEPS * size:
                raise ValueError(f"the {split} set holds fewer than {correctness.STEPS} batches")
            parts = [list(range(i * size, (i + 1) * size)) for i in range(correctness.STEPS)]
            batches[split] = [self._collate(split, [loader.graphs[j] for j in part], loader.pads[-1])
                              for part in parts]
            rows[split] = [[row_of[j] for j in part] for part in parts]
        name = self.config["data"]["tensor_target_name"]
        for _, targets in batches["val"]:
            # the eval loss is then the predictions' mean square (correctness.py)
            targets[name] = np.zeros_like(targets[name])
        self.first.attach()
        try:
            fit_once(self.trainer, batches["train"], batches["val"])
        finally:
            self.first.detach()
        return rows

    def warm_shapes(self) -> int:
        """One `fit` epoch of two train batches at each other shape of the
        train loader's ladder and two validation batches at each other shape
        of the validation loader's, of the split's smallest crystals;
        returns the shapes warmed."""
        batches = {}
        for split, loader in self.loaders.items():
            small = sorted(loader.graphs, key=lambda g: (g.num_edges, g.num_nodes))[:loader.batch_size]
            batches[split] = [self._collate(split, small, pad) for pad in loader.pads[:-1] for _ in range(2)]
        fit_once(self.trainer, batches["train"], batches["val"])
        return sum(len(b) for b in batches.values()) // 2

    def free(self) -> None:
        """Free the step graphs and the trainer; the first steps' readings stay."""
        self.trainer.free_graphs()
        self.first.trainer = None
        del self.trainer, self.first.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _device(device: torch.device) -> Dict[str, Any]:
    """The devices the run used: one card, or the CPU in the tests."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved(device))}


def reported(metrics: List[Dict[str, Any]], cell: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The metrics that a cell reports: those whose `workloads` list it, and
    those without the key."""
    return [m for m in metrics if cell["name"] in m.get("workloads", [cell["name"]])]


def run_cell(bench: Dict[str, Any], cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float) -> Dict[str, Any]:
    """One run; returns the result line's object, `checks` last."""
    if cell["chips"] != 1:
        raise ValueError(f"cell {cell['name']} asks for {cell['chips']} chips; the harness drives one")
    config = load("configs", cell["config"])
    mix = load("traffic", cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="bench-data-") as tmp:
        marks = [("start", time.perf_counter() - t0)]
        prog = Program(config, mix, seed, device, Path(tmp))
        marks.append(("data, model and compared steps", time.perf_counter() - t0))
        shapes = prog.warm_shapes()
        marks.append((f"{shapes} more pad shapes warmed", time.perf_counter() - t0))
        fit_epochs(prog.trainer, prog.dm, lambda done: done >= int(mix["warmup_epochs"]))
        prog.trainer.history.clear()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks.append(("warm-up epochs", time.perf_counter() - t0))
        print("set-up (s since start): " + ", ".join(f"{k} {v:.3f}" for k, v in marks), file=sys.stderr)
        if trace:
            metrics, extra = _traced(bench, cell, config, prog, device, Path(tmp))
        else:
            values, extra = _window(prog, seconds, device, t0)
            metrics = {m["name"]: {"value": values[base(m["name"])], "unit": m["unit"]}
                       for m in reported(bench["end_to_end"], cell)}
            print(f"window: {extra.pop('window')}", file=sys.stderr)
        result = {"attempted": extra.pop("attempted"), "failed": extra.pop("failed"), "metrics": metrics,
                  "device": dict(_device(device), **extra.pop("device", {}))}
        if "breakdown" in extra:
            result["breakdown"] = extra.pop("breakdown")
        weights, rows = prog.weights, prog.rows
        program = prog.first.readings()
        prog.free()
        ref_data = correctness.ReferenceData(config, prog.files)
        reference = correctness.reference_readings(ref_data, rows, weights, device)
    numbers = correctness.compare(program, reference)
    limits = config["limits"]
    correct = correctness.judge(numbers, limits) and result["failed"] == 0
    out = {"correct": bool(correct)}
    out.update(result)
    out["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return out


def _timed(prog: Program, stop: Callable[[int], bool], device: torch.device):
    """Whole `fit` epochs until `stop`, timed by the host's clock to the
    card's end of their work: (epochs, seconds)."""
    start = time.perf_counter()
    epochs = fit_epochs(prog.trainer, prog.dm, stop)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return epochs, time.perf_counter() - start


def _window(prog: Program, seconds: float, device: torch.device, t0: float):
    """The measured window: whole epochs until `seconds` have passed;
    returns the quantities by base name."""
    steal, cpu = _steal_s(), time.process_time()
    start = time.perf_counter()
    setup_s = start - t0
    epochs, window_s = _timed(prog, lambda done: time.perf_counter() - start >= seconds, device)
    cpu, steal = time.process_time() - cpu, _steal_s() - steal
    crystals = sum(g for g, _, _, _ in epochs.log["train"])
    steps = len(epochs.log["train"])
    values = {"train_crystals_per_s": crystals / window_s,
              "train_peak_mib": torch.cuda.max_memory_reserved(device) / 2**20 if device.type == "cuda" else 0.0,
              "setup_s": setup_s}
    lr_scale = min((h["lr_scale"] for h in prog.trainer.history), default=1.0)
    times = sorted(h["epoch_time"] for h in prog.trainer.history)
    return values, {"attempted": steps, "failed": _failed(prog.trainer, steps),
                    "window": {"epochs": epochs.epochs, "seconds": window_s, "lr_scale": lr_scale,
                               "epoch_s_min_median_max": [times[0], times[len(times) // 2], times[-1]],
                               "process_cpu_s": cpu, "host_steal_s": steal}}


def _failed(trainer, steps: int) -> int:
    """The train steps of the epochs whose mean train loss was not finite."""
    history = trainer.history
    bad = sum(not math.isfinite(h["train/loss"]) for h in history)
    return steps * bad // max(len(history), 1)


def _steal_s() -> float:
    """Seconds the host's hypervisor took from this machine's CPUs, all
    cores summed (/proc/stat); 0 where it cannot be read. For the window's
    stderr line: it tells host noise from the program's own time."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


class Span:
    """What a per-layer metric reads: the trace of the traced epochs with
    their batches (`traced`), the untraced epochs timed before them with
    their host seconds and batches (`timed_s`, `timed`), and the work
    counts of the configuration. A batch is (crystals, nodes, edges), by
    split; `loader_s` holds the untraced train loader's seconds per
    `next()`."""

    def __init__(self, trace, traced: Epochs, timed: Epochs, timed_s: float, work):
        self.trace, self.work, self.timed_s = trace, work, timed_s
        self.traced_epochs, self.timed_epochs = traced.epochs, timed.epochs
        self.traced = {k: [(g, n, e) for g, n, e, _ in v] for k, v in traced.log.items()}
        self.timed = {k: [(g, n, e) for g, n, e, _ in v] for k, v in timed.log.items()}
        self.loader_s = [s for _, _, _, s in timed.log["train"]]


def _traced(bench, cell, config, prog: Program, device: torch.device, tmp: Path):
    """The untraced and the traced epochs and the per-layer metrics read from them."""
    from matten_tpu_torch.utils.timing import profiler

    from benchmark.reference.models.tfn import create_atomic_tensor_model, create_scalar_tensor_model
    from benchmark.chrome_trace import Trace, trace_events
    from benchmark.work import Work

    timed, timed_s = _timed(prog, lambda done: done >= int(prog.mix["timed_epochs"]), device)
    n = int(prog.mix["traced_epochs"])
    prof = profiler()
    prof.start()
    try:
        traced, traced_s = _timed(prog, lambda done: done >= n, device)
    finally:
        prof.stop()
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = Trace(trace_events(path))
    path.unlink()
    create = create_atomic_tensor_model if config["family"] == "atomic" else create_scalar_tensor_model
    # the configuration's own species count; no count of the work depends on the neighbours
    shape_model = create(dict(config["model"]), {"allowed_species": config["crystals"]["species"],
                                                 "average_num_neighbors": 1.0}, device="cpu", seed=0)
    span = Span(trace, traced, timed, timed_s, Work(shape_model, config))
    steps = {k: len(v) for k, v in traced.log.items()}
    print(f"traced: {traced.epochs} epochs in {traced_s:.4f} s, {1e3 * traced_s / steps['train']:.4f} ms per "
          f"train step, device busy {trace.busy_s:.4f} s; untraced: {timed.epochs} epochs in {timed_s:.4f} s, "
          f"{1e3 * timed_s / max(len(timed.log['train']), 1):.4f} ms per train step", file=sys.stderr)
    metrics = {}
    for m in reported(bench["per_layer"], cell):
        value = metric_reader(m["name"])(span)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, {"attempted": steps["train"], "failed": _failed(prog.trainer, steps["train"]),
                     "device": {"busy_s": trace.busy_s, "window_s": traced_s},
                     "breakdown": {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}}
