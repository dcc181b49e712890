"""What both train scripts share: the config, the process group and mesh
of a parallel run, the data module, the trainer, the sidecars, fit and
test.

`trainer.devices: N` or `trainer.mesh: {data, graph, mode}` make the run
one of N = data * graph ranks, each its own process:

    torchrun --nproc-per-node N -m matten_tpu_torch.scripts.train_materials_tensor CONFIG

Every rank reads the data, builds the same model and trains on its block of
each batch; the primary rank alone writes the checkpoint directory, the
sidecars and the log. The sidecar's `model` section is the config's,
without the `graph_parallel_*` hparams the run adds, so a directory
trained on a mesh serves as a one-device model.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from matten_tpu_torch.data.datamodule import TensorDataModule
from matten_tpu_torch.kernels import _build
from matten_tpu_torch.kernels.fused_tp import configure_default_tiers
from matten_tpu_torch.parallel.distributed import initialize_distributed, is_primary_host, world_size
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, save_sidecar
from matten_tpu_torch.train.config import build_mesh_spec, build_trainer_config
from matten_tpu_torch.utils.config_yaml import load_config
from matten_tpu_torch.utils.logging import set_logger

logger = logging.getLogger("train")

# the repository's configs, when the package runs from a checkout
CONFIG_DIR = Path(__file__).resolve().parents[2] / "scripts" / "configs"
_FILE_KEYS = ("trainset_filename", "valset_filename", "testset_filename", "root")


def read_args(default_config: str) -> Tuple[Dict[str, Any], Optional[str], Optional[str]]:
    """(the config the command line names, the device it asks for or None
    for the card, the process-group backend or None for the device's);
    sets up the log: the primary rank's at INFO to stderr and
    matten_tpu.log, the others' warnings to stderr."""
    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default=CONFIG_DIR / default_config)
    p.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend of a mesh run (default: nccl on cuda, gloo on cpu)")
    args = p.parse_args()
    if is_primary_host():
        set_logger("INFO", filename="matten_tpu.log")
    else:
        set_logger("WARNING", filename=None)
    return load_config(args.config), args.device, args.backend


def run(
    config: Dict[str, Any],
    create_model: Callable[..., torch.nn.Module],
    per_atom: bool,
    default_target: str,
    device: Union[str, torch.device, None],
    backend: Optional[str] = None,
) -> Dict[str, float]:
    """Seed, join the process group and build the mesh of a parallel run,
    set up the data, build the model (`create_model` of the family) and
    its task, the trainer, write the sidecars, fit (resuming from `last`
    when `restore` is set), then test the best checkpoint. Returns the test
    metrics (on every rank, the same)."""
    spec = build_mesh_spec(config)
    if device is None:
        # torchrun's ranks on one host: a card each
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if spec else "cuda"
    device = torch.device(device)
    seed = config.get("seed_everything", 35)
    np.random.seed(seed)
    # kernel tier: MATTEN_TP_IMPL=pallas|xla (default: the CUDA kernels),
    # built here, before the group's first collective, so that a cold nvcc
    # build does not count against its timeout
    if configure_default_tiers() == "pallas" and device.type == "cuda":
        _build.load_library()
    mesh = None
    if spec is not None:
        initialize_distributed(backend=backend, device=device)
        if world_size() != spec.n_devices:
            raise ValueError(
                f"trainer.devices / trainer.mesh ask for {spec.n_devices} ranks (data {spec.n_data} x "
                f"graph {spec.n_graph}), but the world has {world_size()} process(es): launch one "
                f"process per rank, e.g. torchrun --nproc-per-node {spec.n_devices} -m "
                "matten_tpu_torch.scripts.train_materials_tensor CONFIG"
            )
        mesh = spec.make_mesh()
        logger.info("mesh: data=%d graph=%d mode=%s", spec.n_data, spec.n_graph, spec.mode)

    dm = TensorDataModule(**config["data"], seed=seed)
    if mesh is None or mesh.rank == 0:
        dm.setup()
    if mesh is not None:
        # the primary rank writes the graph cache, the others then read it
        mesh.barrier()
        if mesh.rank != 0:
            dm.setup()
        dm.set_sharding(**spec.loader_kwargs())
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
    if spec is not None and spec.n_graph > 1:
        hparams.update(graph_parallel_axis="graph", graph_parallel_mode=spec.mode)
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
    trainer = Trainer(model, tasks, tcfg, device=device, mesh=mesh)

    if tcfg.checkpoint_dir and trainer.primary:
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
    try:
        trainer.fit(dm, resume=resume)
        # test with the BEST checkpoint, not the post-plateau final state
        if trainer.has_best():
            trainer.restore_best()
        metrics = trainer.test(dm)
    finally:
        if mesh is not None:
            # the graphs hold the group's NCCL communicators: freed before it is
            trainer.free_graphs()
    logger.info("test metrics (best checkpoint): %s", metrics)
    return metrics
