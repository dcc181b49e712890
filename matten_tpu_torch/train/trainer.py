"""The train step: masked MSE, Adam + L2 in torch semantics, plateau LR.

Counterpart of the single-device step of `matten_tpu/train/trainer.py`
(`Trainer._train_step_impl` and `_eval_step_impl`): a forward in train mode
(batch norm on batch statistics, running statistics updated), the weighted
multi-task masked MSE over real rows, backward, and one optimizer update;
the streaming-MAE metric sums come from the same forward. The optimizers
are torch's own, with the semantics the JAX `_make_tx` reproduces through
optax: "adam" is `torch.optim.Adam(weight_decay=...)` (L2 added to the
gradients), "adamw" is `AdamW` (decoupled decay) and "sgd" is `SGD` with
weight decay.

`state_dict` / `load_state_dict` give and take what
`train.checkpoint.CheckpointManager` saves. `fit()` and the evaluation loop
are not ported yet.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.train.task import Task, masked_abs_err_sum, masked_mse

__all__ = ["TrainerConfig", "Trainer", "ReduceLROnPlateau"]

MetricSums = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


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
    """The JAX `TrainerConfig` without its checkpoint fields (`checkpoint_dir`,
    `save_top_k`, `save_last_every_epochs`) and its TPU dispatch field
    (`scan_steps`). The step and the scheduler read `lr`, `weight_decay`,
    `optimizer`, `scheduler`, `lr_factor` and `lr_patience`; `max_epochs`,
    `early_stopping_patience`, `log_every_epochs` and `seed` are for
    `fit()`, which is not ported yet, and nothing reads them."""

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
    log_every_epochs: int = 1
    seed: int = 35


def make_optimizer(params, config: TrainerConfig) -> torch.optim.Optimizer:
    kind = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW, "sgd": torch.optim.SGD}
    if config.optimizer not in kind:
        raise ValueError(f"unknown optimizer {config.optimizer!r}; expected one of {sorted(kind)}")
    return kind[config.optimizer](params, lr=config.lr, weight_decay=config.weight_decay)


class Trainer:
    """One model, its tasks and its optimizer on one device.

    `device` defaults to the card (`cuda`); the model is moved there. Batches
    passed to the steps must already be on it (`predict.batch_to_device`)."""

    def __init__(
        self,
        model: torch.nn.Module,
        tasks: List[Task],
        config: TrainerConfig,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = torch.device("cuda") if device is None else torch.device(device)
        self.model = model.to(self.device)
        self.tasks = tasks
        self.config = config
        self.optimizer = make_optimizer(self.model.parameters(), config)
        self.scheduler = (
            ReduceLROnPlateau(factor=config.lr_factor, patience=config.lr_patience)
            if config.scheduler != "none"
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

    def _compute_loss(self, preds: Dict, data: Dict, targets: Dict) -> torch.Tensor:
        """Weighted multi-task masked MSE."""
        loss = 0.0
        for task in self.tasks:
            mask = self._task_mask(task, data, targets)
            sw = None
            if not task.per_atom and "target_weight" in data:
                sw = data["target_weight"][:, 0]
            loss = loss + task.loss_weight * masked_mse(
                preds[task.name], targets[task.name], mask, sw
            )
        return loss

    @torch.no_grad()
    def _metric_sums(self, preds: Dict, data: Dict, targets: Dict) -> MetricSums:
        out = {}
        for task in self.tasks:
            mask = self._task_mask(task, data, targets)
            p = task.transform_for_metric(preds[task.name].detach())
            t = task.transform_for_metric(targets[task.name])
            out[task.name] = masked_abs_err_sum(p, t, mask)
        return out

    def _preds(self, data: Dict) -> Dict[str, torch.Tensor]:
        out = self.model(data)
        return out if isinstance(out, dict) else {self.tasks[0].name: out}

    # ------------------------------------------------------------------
    def train_step(self, data: Dict, targets: Dict) -> Tuple[torch.Tensor, MetricSums]:
        """Forward (train mode), loss, backward, one optimizer update.

        Returns the loss (a detached 0-d tensor on the device; reading it
        syncs the host) and the metric (sum, count) pairs per task."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        preds = self._preds(data)
        loss = self._compute_loss(preds, data, targets)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), self._metric_sums(preds, data, targets)

    @torch.no_grad()
    def eval_step(self, data: Dict, targets: Dict) -> Tuple[torch.Tensor, MetricSums]:
        """Forward on the running statistics: (loss, metric sums)."""
        self.model.eval()
        preds = self._preds(data)
        return self._compute_loss(preds, data, targets), self._metric_sums(preds, data, targets)

    def set_lr(self, lr: float) -> None:
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
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler = ReduceLROnPlateau(**state["scheduler"])
