"""What both train scripts share: the config, the data module, the
trainer, the sidecars, fit and test."""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from matten_tpu_torch.data.datamodule import TensorDataModule
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, save_sidecar
from matten_tpu_torch.train.config import build_mesh_spec, build_trainer_config
from matten_tpu_torch.utils.config_yaml import load_config

logger = logging.getLogger("train")

# the repository's configs, when the package runs from a checkout
CONFIG_DIR = Path(__file__).resolve().parents[2] / "scripts" / "configs"
_FILE_KEYS = ("trainset_filename", "valset_filename", "testset_filename", "root")


def read_args(default_config: str) -> Tuple[Dict[str, Any], Optional[str]]:
    """(the config the command line names, the device it asks for or None
    for the card)."""
    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default=CONFIG_DIR / default_config)
    p.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    args = p.parse_args()
    return load_config(args.config), args.device


def run(
    config: Dict[str, Any],
    create_model: Callable[..., torch.nn.Module],
    per_atom: bool,
    default_target: str,
    device: Union[str, torch.device, None],
) -> Dict[str, float]:
    """Seed, set up the data, build the model (`create_model` of the
    family) and its task, the trainer, write the sidecars, fit (resuming
    from `last` when `restore` is set), then test the best checkpoint.
    Returns the test metrics."""
    device = torch.device("cuda") if device is None else torch.device(device)
    seed = config.get("seed_everything", 35)
    np.random.seed(seed)
    build_mesh_spec(config)  # one device: refuses a multi-device config

    dm = TensorDataModule(**config["data"], seed=seed)
    dm.setup()
    dataset_hparams = dm.get_to_model_info()
    logger.info("dataset hand-off: %s", dataset_hparams)

    # the graph-level script trains the scalar targets the data section
    # names beside the tensor, each with a 0e head, a weighted loss term and
    # its MAE (the per-atom script has no scalar heads, as in JAX)
    name = config["data"].get("tensor_target_name", default_target)
    scalar_names = [] if per_atom else list(config["data"].get("scalar_target_names") or [])
    norm_scalars = list(config["data"].get("normalize_scalar_targets") or [])
    task_weights = config["model"].get("task_weights") or {}
    hparams = {k: v for k, v in config["model"].items() if k != "task_weights"}
    if not per_atom:
        hparams.update(tensor_target_name=name, scalar_target_names=scalar_names)
    model = create_model(hparams, dataset_hparams, device=device, seed=seed)
    weight = float(task_weights.get(name, 1.0))
    tasks = [CanonicalRegressionTask(
        name=name,
        per_atom=per_atom,
        loss_weight=weight,
        metric_weight=weight,
        normalizer=dm.statistics.target_normalizer if dm.normalize_tensor_target else None,
    )]
    for i, scalar in enumerate(scalar_names):
        weight = float(task_weights.get(scalar, 1.0))
        normalized = i < len(norm_scalars) and bool(norm_scalars[i])
        tasks.append(CanonicalRegressionTask(
            name=scalar,
            loss_weight=weight,
            metric_weight=weight,
            normalizer=dm.statistics.scalar_normalizers[scalar] if normalized else None,
        ))
    tcfg = build_trainer_config(config)
    trainer = Trainer(model, tasks, tcfg, device=device)

    if tcfg.checkpoint_dir:
        save_sidecar(
            tcfg.checkpoint_dir,
            hparams={
                "model": config["model"],
                "data": {k: v for k, v in config["data"].items() if k not in _FILE_KEYS},
                "dataset_hparams": dataset_hparams,
                "normalize_tensor_target": dm.normalize_tensor_target,
            },
            statistics_arrays=dm.statistics.to_arrays(),
        )

    resume = bool(config.get("restore", config.get("trainer", {}).get("restore", False)))
    trainer.fit(dm, resume=resume)
    # test with the BEST checkpoint, not the post-plateau final state
    if trainer.has_best():
        trainer.restore_best()
    metrics = trainer.test(dm)
    logger.info("test metrics (best checkpoint): %s", metrics)
    return metrics
