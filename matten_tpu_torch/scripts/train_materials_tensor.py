"""Train a graph-level tensor model (e.g. crystal elasticity).

    python -m matten_tpu_torch.scripts.train_materials_tensor [path/to/config.yaml] [--device cpu]
    torchrun --nproc-per-node N -m matten_tpu_torch.scripts.train_materials_tensor CONFIG  # trainer.devices / trainer.mesh

Counterpart of `scripts/train_materials_tensor.py`: a config with data /
model / trainer / optimizer / lr_scheduler sections (read with the port's
own YAML reader), the seed, the data module, the model from the hparams and
the dataset hand-off, the sidecars, fit, then test with the best
checkpoint. Runs on the card unless `main` is given another device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.scripts._common import read_args, run


def main(config: Dict[str, Any], device: Union[str, torch.device, None] = None,
         backend: Optional[str] = None) -> Dict[str, float]:
    """Train and test from a config dict; returns the test metrics. With
    `trainer.devices` / `trainer.mesh`, this process is one rank of the run
    (a process group up already, or torchrun's environment; `backend` by
    default nccl on the card, gloo on the CPU)."""
    return run(config, create_scalar_tensor_model, per_atom=False, default_target="elastic_tensor_full", device=device, backend=backend)


if __name__ == "__main__":
    main(*read_args("materials_tensor.yaml"))
