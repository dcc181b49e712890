"""Train a per-atom tensor model (e.g. Si NMR shielding).

    python -m matten_tpu_torch.scripts.train_atomic_tensor [path/to/config.yaml] [--device cpu]

Counterpart of `scripts/train_atomic_tensor.py`: as the materials script,
with the per-atom model and a per-atom task (the loss and the MAE over the
atoms the selector marks). Runs on the card unless `main` is given another
device.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

from matten_tpu_torch.models import create_atomic_tensor_model
from matten_tpu_torch.scripts._common import read_args, run
from matten_tpu_torch.utils.logging import set_logger


def main(config: Dict[str, Any], device: Union[str, torch.device, None] = None) -> Dict[str, float]:
    """Train and test from a config dict; returns the test metrics."""
    return run(config, create_atomic_tensor_model, per_atom=True, default_target="nmr_tensor", device=device)


if __name__ == "__main__":
    set_logger("INFO", filename="matten_tpu.log")
    main(*read_args("atomic_tensor.yaml"))
