"""Train a per-atom tensor model (e.g. Si NMR shielding).

    python -m matten_tpu_torch.scripts.train_atomic_tensor [path/to/config.yaml] [--device cpu]
    torchrun --nproc-per-node N -m matten_tpu_torch.scripts.train_atomic_tensor CONFIG  # trainer.devices / trainer.mesh

Counterpart of `scripts/train_atomic_tensor.py`: as the materials script,
with the per-atom model and a per-atom task (the loss and the MAE over the
atoms the selector marks). Runs on the card unless `main` is given another
device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from matten_tpu_torch.models import create_atomic_tensor_model
from matten_tpu_torch.scripts._common import read_args, run


def main(config: Dict[str, Any], device: Union[str, torch.device, None] = None,
         backend: Optional[str] = None) -> Dict[str, float]:
    """Train and test from a config dict; returns the test metrics. With
    `trainer.devices` / `trainer.mesh`, this process is one rank of the run
    (a process group up already, or torchrun's environment; `backend` by
    default nccl on the card, gloo on the CPU)."""
    return run(config, create_atomic_tensor_model, per_atom=True, default_target="nmr_tensor", device=device, backend=backend)


if __name__ == "__main__":
    main(*read_args("atomic_tensor.yaml"))
