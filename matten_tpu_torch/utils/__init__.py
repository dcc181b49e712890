"""Utilities: anomaly detection, timing and profiling, logging, the YAML
config reader and W&B logging (counterparts of `matten_tpu/utils/`)."""

from matten_tpu_torch.utils.anomaly import check_finite, DetectAnomaly
from matten_tpu_torch.utils.timing import TimeMeter, profile_trace
from matten_tpu_torch.utils.logging import set_logger

__all__ = [
    "check_finite",
    "DetectAnomaly",
    "TimeMeter",
    "profile_trace",
    "set_logger",
]
