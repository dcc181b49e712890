"""Training harness: tasks, the train step, the plateau scheduler
(counterparts of `matten_tpu/train/`)."""

from matten_tpu_torch.train.task import CanonicalRegressionTask, Task
from matten_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Task", "CanonicalRegressionTask", "Trainer", "TrainerConfig"]
