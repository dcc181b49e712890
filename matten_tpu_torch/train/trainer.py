"""The training loop: train and eval steps, plateau LR, early stopping,
best-k and `last` checkpoints, resume.

Counterpart of the single-device `matten_tpu/train/trainer.py`. A train
step is a forward in train mode (batch norm on batch statistics, running
statistics updated), the weighted multi-task masked MSE over real rows,
backward, and one optimizer update; the streaming-MAE metric sums come from
the same forward. The optimizers are torch's own, with the semantics the
JAX `_make_tx` reproduces through optax: "adam" is
`torch.optim.Adam(weight_decay=...)` (L2 added to the gradients), "adamw"
is `AdamW` (decoupled decay) and "sgd" is `SGD` with weight decay.

`fit(datamodule, resume=False)` trains `self.model` in place, epoch after
epoch: the loader reseeded per epoch, the train steps, an evaluation on the
val set, the plateau scheduler on `val/score`, then a best-k save, early
stopping, and the rolling `last` checkpoint with the loop state that
`resume=True` continues from. It returns `self.history`, one record per
epoch with the JAX loop's keys.

On the card a single-device trainer runs each train step and each eval step
as a replay of a CUDA graph captured once per padded batch shape
(`train/graphs.py`), the counterpart of the JAX trainer's `jax.jit` steps:
the first step of a shape runs eagerly, the second captures it, and every
later one is one graph launch. `TrainerConfig.scan_steps = K` groups up to
K consecutive batches of one shape as the JAX fit loop does for its
`lax.scan` (a shape change flushes the group; batch order and resume
replay are unchanged): each group's batches are checked on the host
(`fused_conv.check_edges`, the check a captured step cannot make), stacked
and copied to the card in one pinned, non-blocking copy per field, and
their steps dispatched back to back; a group's losses come back as [K].
Nothing in an epoch waits on the card but the two readbacks, the mean train
loss and the evaluation sums. The mesh ranks (NCCL and gloo collectives
are not captured), a model built at DEBUG log level (its anomaly checks
read back every layer) and the CPU run every step eagerly, with the same
grouping.

With `mesh` (`parallel.make_mesh`), the trainer is one rank of a data and
graph parallel run, the counterpart of the JAX trainer's `shard_map`
steps: every rank builds the same model from the same seed, takes its
block of each stacked batch (`parallel.sharding.local_block`), and the
step equals the single-device step on the whole batch. The loss is the
exact global masked mean (each task's sum and count summed over the data
axis, and over the graph axis for per-atom tasks under the node modes);
after the backward, whose collectives are exact transposes, the gradients
are summed over every rank and divided by the world size; the batch-norm
running statistics are averaged over the data axis; the metric sums are
summed as the loss's. So every rank holds the same parameters, losses and
metrics and takes the same plateau and early-stopping decisions; only the
primary rank writes checkpoints and logs, and every rank reads them back.
"""

from __future__ import annotations

import logging
import time
from dataclasses import asdict, dataclass, field as dc_field
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.kernels.fused_conv import check_edges
from matten_tpu_torch.parallel.collectives import psum
from matten_tpu_torch.parallel.sharding import MESH, NODE_MODES, Mesh, local_block
from matten_tpu_torch.train.checkpoint import CheckpointManager
from matten_tpu_torch.train.graphs import StepGraphs, batch_key
from matten_tpu_torch.train.task import Task, masked_abs_err_sum, masked_mse_sums
from matten_tpu_torch.utils.anomaly import DetectAnomaly

logger = logging.getLogger(__name__)

__all__ = ["TrainerConfig", "Trainer", "ReduceLROnPlateau"]

MetricSums = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
TensorBatch = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


@dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch ReduceLROnPlateau semantics)."""

    factor: float = 0.5
    patience: int = 50
    mode: str = "min"
    min_lr: float = 0.0
    best: float = dc_field(default=float("inf"))
    num_bad: int = 0
    scale: float = 1.0

    def step(self, score: float) -> bool:
        """Returns True if the LR was reduced this step."""
        improved = score < self.best if self.mode == "min" else score > self.best
        if improved:
            self.best = score
            self.num_bad = 0
            return False
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.scale *= self.factor
            self.num_bad = 0
            return True
        return False


@dataclass
class TrainerConfig:
    """The JAX `TrainerConfig`."""

    max_epochs: int = 1000
    lr: float = 0.01
    weight_decay: float = 1e-5
    # "adam" (torch-Adam semantics, L2 added to gradients) | "adamw"
    # (decoupled decay) | "sgd" (exact-parity tests)
    optimizer: str = "adam"
    # "plateau" (ReduceLROnPlateau on val/score) | "none" (constant LR)
    scheduler: str = "plateau"
    lr_factor: float = 0.5
    lr_patience: int = 50
    early_stopping_patience: int = 150
    checkpoint_dir: Optional[str] = None
    save_top_k: int = 3
    log_every_epochs: int = 1
    seed: int = 35
    # group up to this many consecutive batches of one padded shape, as the
    # JAX fit loop does for one `lax.scan` dispatch; on the card their
    # graphed steps are dispatched back to back from one stacked copy. 1
    # takes every batch alone; the result is the same either way
    scan_steps: int = 1
    # save the rolling `last` checkpoint every N epochs (and always at the
    # final or stopping epoch); a crash loses fewer than N epochs
    save_last_every_epochs: int = 1


def make_optimizer(params, config: TrainerConfig, capturable: bool = False) -> torch.optim.Optimizer:
    """The config's optimizer; `capturable`: Adam and AdamW keep their step
    count on the device, so that a CUDA graph can capture their update (SGD
    has no state to keep)."""
    kind = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW, "sgd": torch.optim.SGD}
    if config.optimizer not in kind:
        raise ValueError(f"unknown optimizer {config.optimizer!r}; expected one of {sorted(kind)}")
    extra = {"capturable": capturable} if config.optimizer != "sgd" else {}
    return kind[config.optimizer](params, lr=config.lr, weight_decay=config.weight_decay, **extra)


def _check_graph_mode(model: torch.nn.Module, mesh: Mesh) -> None:
    """The mesh's graph shard mode is the one the model's convs were built
    for (`graph_parallel_mode`), and a mesh that splits graphs has a
    graph-parallel model."""
    modes = {m.graph_shard_mode for m in model.modules() if getattr(m, "graph_axis", None) is not None}
    if (modes or mesh.n_graph > 1) and modes != {mesh.mode}:
        raise ValueError(
            f"the mesh splits graphs over {mesh.n_graph} rank(s) in mode {mesh.mode!r}, but the model's "
            f"convs are built for {sorted(modes) or 'one device (no graph_parallel_axis)'}"
        )


class Trainer:
    """One model, its tasks and its optimizer on one device, or on one rank
    of a mesh.

    `device` defaults to the card (`cuda`); the model is moved there. Batches
    passed to the steps must already be on it (`predict.batch_to_device`;
    with a mesh, this rank's block: `parallel.shard_batch`); `fit`, `test`
    and `_run_eval` take numpy batches from loaders and copy them.
    `metrics_logger`, an object with `.log(record, step=)`, gets each
    epoch's history record. `mesh` makes it one rank of a parallel run
    (module docstring); the mesh's mode must be the model's
    `graph_parallel_mode`. On the card without a mesh the steps are CUDA
    graph replays (module docstring)."""

    def __init__(
        self,
        model: torch.nn.Module,
        tasks: List[Task],
        config: TrainerConfig,
        device: Union[str, torch.device, None] = None,
        metrics_logger=None,
        mesh: Optional[Mesh] = None,
    ):
        self.device = torch.device("cuda") if device is None else torch.device(device)
        self.model = model.to(self.device)
        self.tasks = tasks
        self.config = config
        self.metrics_logger = metrics_logger
        self.mesh = mesh
        if mesh is not None:
            _check_graph_mode(model, mesh)
        self.primary = mesh is None or mesh.rank == 0
        # the running statistics, averaged over the data axis after a step
        self._statistics = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
        # Adam's update as a graph captures it wherever a step can be captured,
        # so an eager step (DEBUG) computes the same update
        capturable = self.device.type == "cuda" and mesh is None
        self.optimizer = make_optimizer(self.model.parameters(), config, capturable=capturable)
        # DEBUG-level models check every layer's output on the host
        graphs = capturable and not any(isinstance(m, DetectAnomaly) for m in model.modules())
        self._graphs = StepGraphs({"train": self._train_step, "eval": self._eval_step},
                                  lambda kind: self.model.train(kind == "train")) if graphs else None
        self.scheduler = (
            ReduceLROnPlateau(factor=config.lr_factor, patience=config.lr_patience)
            if config.scheduler != "none"
            else None
        )
        self.history: List[Dict[str, float]] = []
        self._ckpt_manager = (
            CheckpointManager(config.checkpoint_dir, save_top_k=config.save_top_k, writer=self.primary)
            if config.checkpoint_dir is not None
            else None
        )

    # ------------------------------------------------------------------
    def _task_mask(self, task: Task, data: Dict, targets: Dict) -> torch.Tensor:
        if task.per_atom:
            mask = data[K.NODE_MASK]
            sel = targets.get("atom_selector")
            if sel is not None:
                mask = mask & sel.bool()
            return mask
        return data[K.GRAPH_MASK]

    def _global(self, task: Task, x: torch.Tensor) -> torch.Tensor:
        """A task's sum over this rank's rows summed over the ranks that
        hold its other rows: the data axis, and the graph axis for per-atom
        rows under the node modes (identity without a mesh)."""
        if self.mesh is None:
            return x
        x = psum(x, self.mesh.data)
        if task.per_atom and self.mesh.mode in NODE_MODES:
            x = psum(x, self.mesh.graph)
        return x

    def _compute_loss(self, preds: Dict, data: Dict, targets: Dict) -> torch.Tensor:
        """Weighted multi-task masked MSE; with a mesh the exact mean over
        the whole batch's rows, the same on every rank."""
        loss = 0.0
        for task in self.tasks:
            mask = self._task_mask(task, data, targets)
            sw = None
            if not task.per_atom and "target_weight" in data:
                sw = data["target_weight"][:, 0]
            num, den = masked_mse_sums(preds[task.name], targets[task.name], mask, sw)
            term = self._global(task, num) / self._global(task, den).clamp_min(1.0)
            loss = loss + task.loss_weight * term
        return loss

    @torch.no_grad()
    def _metric_sums(self, preds: Dict, data: Dict, targets: Dict) -> MetricSums:
        out = {}
        for task in self.tasks:
            mask = self._task_mask(task, data, targets)
            p = task.transform_for_metric(preds[task.name].detach())
            t = task.transform_for_metric(targets[task.name])
            s, c = masked_abs_err_sum(p, t, mask)
            out[task.name] = (self._global(task, s), self._global(task, c))
        return out

    @torch.no_grad()
    def _reduce_across_ranks(self) -> None:
        """After a backward with a mesh: each gradient summed over every
        rank and divided by the world size (the single-device gradient, see
        `parallel/collectives.py`), the running statistics averaged over
        the data axis; one all_reduce each."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        for tensors, group, n in ((grads, None, self.mesh.size),
                                  (self._statistics, self.mesh.data.group, self.mesh.n_data)):
            if n == 1 or not tensors:
                continue
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.all_reduce(flat, group=group)
            flat /= n
            for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.copy_(v.view_as(t))

    def _preds(self, data: Dict) -> Dict[str, torch.Tensor]:
        out = self.model(data)
        return out if isinstance(out, dict) else {self.tasks[0].name: out}

    # ------------------------------------------------------------------
    def _step(self, kind: str, data: Dict, targets: Dict) -> Tuple[torch.Tensor, MetricSums]:
        if self._graphs is None or torch.is_anomaly_enabled():
            return (self._train_step if kind == "train" else self._eval_step)(data, targets)
        return self._graphs.run(kind, data, targets)

    def train_step(self, data: Dict, targets: Dict) -> Tuple[torch.Tensor, MetricSums]:
        """Forward (train mode), loss, backward, one optimizer update; on the
        card a CUDA graph's replay from the second step of a batch shape on.

        Returns the loss (a detached 0-d tensor on the device, a copy the
        next step leaves alone; reading it syncs the host) and the metric
        (sum, count) pairs per task."""
        return self._step("train", data, targets)

    def eval_step(self, data: Dict, targets: Dict) -> Tuple[torch.Tensor, MetricSums]:
        """Forward on the running statistics: (loss, metric sums); on the
        card a graph's replay as `train_step`'s."""
        return self._step("eval", data, targets)

    def _train_step(self, data: Dict, targets: Dict) -> Tuple[torch.Tensor, MetricSums]:
        """`train_step`, eagerly."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        preds = self._preds(data)
        loss = self._compute_loss(preds, data, targets)
        loss.backward()
        if self.mesh is not None:
            self._reduce_across_ranks()
        self.optimizer.step()
        return loss.detach(), self._metric_sums(preds, data, targets)

    @torch.no_grad()
    def _eval_step(self, data: Dict, targets: Dict) -> Tuple[torch.Tensor, MetricSums]:
        """`eval_step`, eagerly."""
        self.model.eval()
        preds = self._preds(data)
        return self._compute_loss(preds, data, targets), self._metric_sums(preds, data, targets)

    def set_lr(self, lr: float) -> None:
        """The learning rate of every param group; a captured train step,
        which holds the old one, is captured anew at its next step."""
        if any(group["lr"] != lr for group in self.optimizer.param_groups) and self._graphs is not None:
            self._graphs.drop("train")
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The train state a checkpoint holds: the model's `state_dict`
        (with the batch-norm running statistics), the optimizer's, and the
        plateau scheduler's fields (None without a scheduler)."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": None if self.scheduler is None else asdict(self.scheduler),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a `state_dict()`: the model strictly, then the optimizer
        and the scheduler."""
        if (state["scheduler"] is None) != (self.scheduler is None):
            raise ValueError("the checkpoint's scheduler does not match this trainer's config")
        self.model.load_state_dict(state["model"])
        opt = state["optimizer"]
        if "capturable" in self.optimizer.defaults:
            # this trainer's own choice, whatever the writer's was: the load
            # puts the step counts where it needs them
            capturable = self.optimizer.defaults["capturable"]
            opt = dict(opt, param_groups=[dict(g, capturable=capturable) for g in opt["param_groups"]])
        self.optimizer.load_state_dict(opt)
        if self._graphs is not None:
            # new optimizer state tensors: the train graphs read the old ones
            self._graphs.drop("train")
        if self.scheduler is not None:
            self.scheduler = ReduceLROnPlateau(**state["scheduler"])

    # ------------------------------------------------------------------
    def _groups(self, loader: Iterable) -> Iterator[List[Tuple[Dict, Dict]]]:
        """The loader's batches in groups, as the JAX fit loop groups them
        for its `lax.scan`: consecutive batches of one `batch_key`,
        `scan_steps` of them, or fewer where a shape change or the loader's
        end cuts the group short."""
        k = max(self.config.scan_steps, 1)
        group, key = [], None
        for batch in loader:
            b_key = batch_key(*batch)
            if group and b_key != key:
                yield group
                group = []
            key = b_key
            group.append(batch)
            if len(group) == k:
                yield group
                group = []
        if group:
            yield group

    def _device_group(self, group: List[Tuple[Dict, Dict]]) -> List[Tuple[Tuple[Dict, Dict], TensorBatch]]:
        """(numpy batch, the batch on the device) for each batch of a group;
        with a mesh, this rank's block of it on the device, with the mesh.

        Without a mesh each batch's edges are checked here, on the host
        (`fused_conv.check_edges`: a captured forward does not check them).
        Each field of the group's batches is stacked and copied in one copy,
        on the card from pinned memory and non-blocking, so that no copy
        waits for the steps queued before it."""
        if self.mesh is None:
            for data, _ in group:
                src, dst = data[K.EDGE_INDEX]
                n = data[K.NODE_MASK].shape[0]
                check_edges(src, dst, n, n)
            blocks = group
        else:
            per_atom = [t.name for t in self.tasks if t.per_atom]
            blocks = [local_block(self.mesh, b, per_atom) for b in group]
        parts = []
        for i in range(2):
            stacked = {}
            for k in blocks[0][i]:
                host = torch.from_numpy(np.stack([np.asarray(b[i][k]) for b in blocks]))
                if self.device.type == "cuda":
                    host = host.pin_memory()
                stacked[k] = host.to(self.device, non_blocking=True).unbind(0)
            parts.append([{k: v[j] for k, v in stacked.items()} for j in range(len(blocks))])
        if self.mesh is not None:
            parts[0] = [dict(d, **{MESH: self.mesh}) for d in parts[0]]
        return list(zip(group, zip(*parts)))

    def _run_eval(self, loader: Iterable) -> Dict[str, float]:
        """Loss and MAE per task over a loader, and the score (the sum of
        metric_weight * MAE). The sums stay on the device and are read back
        once. An empty loader gives loss nan and score inf, so it never
        becomes the best checkpoint."""
        n = 0
        loss_sum = torch.zeros((), device=self.device)
        sums = {t.name: [torch.zeros((), device=self.device)] * 2 for t in self.tasks}
        for group in self._groups(loader):
            n += len(group)
            for _, (data, targets) in self._device_group(group):
                loss, ms = self.eval_step(data, targets)
                loss_sum = loss_sum + loss
                for name, (s, c) in ms.items():
                    sums[name] = [sums[name][0] + s, sums[name][1] + c]
        if n == 0:
            return {"loss": float("nan"), "score": float("inf")}
        packed = torch.stack([loss_sum] + [x for t in self.tasks for x in sums[t.name]]).tolist()
        out = {"loss": packed[0] / n}
        score = 0.0
        for i, t in enumerate(self.tasks):
            mae = packed[1 + 2 * i] / max(packed[2 + 2 * i], 1.0)
            out[f"mae/{t.name}"] = mae
            score += t.metric_weight * mae
        out["score"] = score
        return out

    def test(self, datamodule) -> Dict[str, float]:
        """`_run_eval` over the test loader with the current weights."""
        return self._run_eval(datamodule.test_dataloader())

    def _manager(self) -> CheckpointManager:
        if self._ckpt_manager is None:
            raise ValueError("no checkpoint_dir configured")
        return self._ckpt_manager

    def restore_last(self) -> None:
        """Load the `last` checkpoint into the model, optimizer and scheduler."""
        self.load_state_dict(self._manager().restore(last=True, device=self.device))

    def restore_best(self) -> None:
        """Load the best-val/score checkpoint (what the scripts test)."""
        self.load_state_dict(self._manager().restore(device=self.device))

    def has_best(self) -> bool:
        return self._ckpt_manager is not None and self._ckpt_manager.best_epoch is not None

    def _loop_state(self, epoch, best_score, best_epoch, epochs_no_improve) -> Dict[str, Any]:
        return {
            "epoch": epoch,
            "best_score": best_score,
            "best_epoch": best_epoch,
            "epochs_no_improve": epochs_no_improve,
            "scheduler": (
                {"best": self.scheduler.best, "num_bad": self.scheduler.num_bad, "scale": self.scheduler.scale}
                if self.scheduler is not None
                else None
            ),
        }

    def fit(self, datamodule, resume: bool = False) -> List[Dict[str, float]]:
        """Train until max_epochs or an early stop; returns `self.history`.

        `resume=True` continues from the `last` checkpoint: the model,
        optimizer and scheduler state, the epoch index, the best score and
        epoch, and the early-stopping counter, so a killed run reproduces
        the uninterrupted run's schedule and batch order."""
        cfg = self.config
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()

        start_epoch = 0
        best_score = float("inf")
        best_epoch = -1
        epochs_no_improve = 0
        t_start = time.time()

        if resume and self._ckpt_manager is not None and self._ckpt_manager.has_last():
            self.restore_last()
            loop = self._ckpt_manager.load_loop_state()
            if loop is not None:
                start_epoch = int(loop["epoch"]) + 1
                best_score = float(loop["best_score"])
                best_epoch = int(loop["best_epoch"])
                epochs_no_improve = int(loop["epochs_no_improve"])
                sch = loop.get("scheduler")
                if self.scheduler is not None and sch is not None:
                    self.scheduler.best = float(sch["best"])
                    self.scheduler.num_bad = int(sch["num_bad"])
                    self.scheduler.scale = float(sch["scale"])
                    self.set_lr(cfg.lr * self.scheduler.scale)
            logger.info("resumed from `last` at epoch %d", start_epoch)

        for epoch in range(start_epoch, cfg.max_epochs):
            t0 = time.time()
            # per-epoch reseed: epoch k draws the same batch order whether or
            # not training was interrupted before it
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            train_losses = []
            epoch_edges = 0
            for group in self._groups(train_loader):
                losses = []
                for (host, _), (data, targets) in self._device_group(group):
                    epoch_edges += int(host[K.EDGE_MASK].sum())
                    losses.append(self.train_step(data, targets)[0])
                train_losses.append(torch.stack(losses))

            val_metrics = self._run_eval(val_loader)
            score = val_metrics["score"]
            train_loss = torch.cat(train_losses).mean().item() if train_losses else float("nan")

            # plateau scheduler, then best-k save and early stopping on val/score
            if self.scheduler is not None and self.scheduler.step(score):
                new_lr = cfg.lr * self.scheduler.scale
                logger.info("epoch %d: reducing lr to %g", epoch, new_lr)
                self.set_lr(new_lr)

            if score < best_score:
                best_score = score
                best_epoch = epoch
                epochs_no_improve = 0
                if self._ckpt_manager is not None:
                    self._ckpt_manager.save(epoch, self.state_dict(), metrics={"val/score": score})
            else:
                epochs_no_improve += 1

            epoch_time = time.time() - t0
            rec = {
                "epoch": epoch,
                "train/loss": train_loss,
                "val/loss": val_metrics["loss"],
                "val/score": score,
                "lr_scale": self.scheduler.scale if self.scheduler else 1.0,
                "epoch_time": epoch_time,
                "cumulative_time": time.time() - t_start,
                "train/edges_per_s": epoch_edges / max(epoch_time, 1e-9),
            }
            rec.update({f"val/{k}": v for k, v in val_metrics.items() if k.startswith("mae")})
            self.history.append(rec)
            if self.metrics_logger is not None and self.primary:
                self.metrics_logger.log(rec, step=epoch)
            if epoch % cfg.log_every_epochs == 0 and self.primary:
                logger.info(
                    "epoch %d: train loss %.5f | val score %.5f | %.2fs",
                    epoch, rec["train/loss"], score, epoch_time,
                )
            stop = epochs_no_improve > cfg.early_stopping_patience
            if self._ckpt_manager is not None and (
                stop
                or epoch == cfg.max_epochs - 1
                or (epoch + 1) % max(cfg.save_last_every_epochs, 1) == 0
            ):
                self._ckpt_manager.save_last(
                    self.state_dict(),
                    self._loop_state(epoch, best_score, best_epoch, epochs_no_improve),
                )
            if stop:
                logger.info("early stopping at epoch %d (best %.5f @ %d)", epoch, best_score, best_epoch)
                break
        if self.mesh is not None:
            # the other ranks read what the primary rank wrote
            self.mesh.barrier()
        return self.history
