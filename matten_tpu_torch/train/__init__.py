"""Training harness: tasks, the train step, the plateau scheduler,
checkpoints (counterparts of `matten_tpu/train/`)."""

from matten_tpu_torch.train.checkpoint import CheckpointManager, load_sidecar, save_sidecar
from matten_tpu_torch.train.task import CanonicalRegressionTask, Task
from matten_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "Task",
    "CanonicalRegressionTask",
    "Trainer",
    "TrainerConfig",
    "CheckpointManager",
    "save_sidecar",
    "load_sidecar",
]
