"""Task definitions: loss + metric + transform hook per prediction target.

Counterpart of `matten_tpu/train/task.py` on torch tensors, single device:
the sums reduce over the local batch only (the JAX functions' `psum`
arguments belong to its sharded steps and have no counterpart here).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

import torch

from benchmark.reference.data.transform import MeanNormNormalize, ScalarNormalize

__all__ = [
    "Task",
    "CanonicalRegressionTask",
    "masked_mse_sums",
    "masked_mse",
    "masked_abs_err_sum",
]


@dataclass
class Task:
    name: str
    loss_weight: float = 1.0
    metric_weight: float = 1.0
    per_atom: bool = False  # per-node target masked by atom_selector
    # inverse before metrics: the tensor target's or a scalar target's
    normalizer: Optional[Union[MeanNormNormalize, ScalarNormalize]] = None
    # (normalizer state, dtype, device) -> its factor and mean on the device
    _on_device: Optional[Tuple[Any, Tuple[torch.Tensor, torch.Tensor]]] = field(
        default=None, init=False, repr=False, compare=False)

    def transform_for_metric(self, x: torch.Tensor) -> torch.Tensor:
        """Map loss-space values to metric space (denormalization)."""
        n = self.normalizer
        if n is not None and n.initialized:
            factor, mean = self._on(x.dtype, x.device)
            return x * factor + mean
        return x

    def _on(self, dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The normalizer's inverse as x * factor + mean: its factor (norm *
        scale, or a scalar target's std) and mean on `device`, copied there
        once per normalizer state (a copy per step would sync the host with
        the card)."""
        n = self.normalizer
        factor = n.std if isinstance(n, ScalarNormalize) else n.norm * n.scale
        key = (factor.tobytes(), n.mean.tobytes(), dtype, device)
        if self._on_device is None or self._on_device[0] != key:
            self._on_device = (key, (torch.as_tensor(factor, dtype=dtype, device=device),
                                     torch.as_tensor(n.mean, dtype=dtype, device=device)))
        return self._on_device[1]


class CanonicalRegressionTask(Task):
    """MSE loss + MAE metric."""


def masked_mse_sums(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    sample_weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squared errors, element count) over rows where mask is True."""
    m = mask.to(pred.dtype)
    if sample_weight is not None:
        m = m * sample_weight.to(pred.dtype)
    se = ((pred - target) ** 2).sum(-1) * m
    return se.sum(), m.sum() * pred.shape[-1]


def masked_mse(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean squared error over rows where mask is True: the sums of
    `masked_mse_sums` (the trainer's loss) divided, over real rows x D
    elements (at least 1)."""
    num, den = masked_mse_sums(pred, target, mask, sample_weight)
    return num / den.clamp_min(1.0)


def masked_abs_err_sum(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum |err|, element count) for streaming MAE accumulation."""
    m = mask.to(pred.dtype)
    ae = (pred - target).abs().sum(-1) * m
    return ae.sum(), m.sum() * pred.shape[-1]
