"""NaN/Inf anomaly detection for the data dict.

Counterpart of `matten_tpu/utils/anomaly.py`: at DEBUG log level the model
factory puts one `DetectAnomaly` after every layer
(`models/tfn.py::create_tfn_backbone`), which raises as soon as a layer's
output holds a non-finite value. `enable_nan_debugging` is autograd's
anomaly mode, which names the backward op that produced a NaN.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["check_finite", "DetectAnomaly", "enable_nan_debugging"]


def check_finite(data: Dict[str, torch.Tensor], where: str = "") -> None:
    """Raise FloatingPointError naming the first float field of `data` that
    holds a NaN or Inf. One count per field, stacked and read back at once:
    on the card one host sync per call (DEBUG only)."""
    names = [k for k, v in data.items() if torch.is_tensor(v) and v.is_floating_point()]
    if not names:
        return
    bad = torch.stack([(~torch.isfinite(data[k].detach())).sum() for k in names]).tolist()
    for name, count in zip(names, bad):
        if count > 0:
            raise FloatingPointError(f"non-finite values in field {name!r} after {where}")


class DetectAnomaly(torch.nn.Module):
    """Layer wrapper: forwards `data` unchanged, checking every field."""

    def __init__(self, label: str = ""):
        super().__init__()
        self.label = label

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        check_finite(data, self.label)
        return data


def enable_nan_debugging() -> None:
    """Autograd's anomaly mode: a backward that produces NaN raises and
    names its forward op (slow; debug only)."""
    torch.autograd.set_detect_anomaly(True)
