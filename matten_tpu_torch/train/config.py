"""Train config -> TrainerConfig (shared by both train scripts).

Counterpart of `matten_tpu/train/config.py`. The optimizer and the LR
scheduler are chosen by the basename of their `class_path` (the reference's
class_path/init_args surface), and an unknown class raises instead of
training with the defaults; the `ModelCheckpoint` and `EarlyStopping`
callbacks give `save_top_k` and the early-stopping patience.

`trainer.scan_steps` is accepted and not used (a value above 1 is logged
at INFO): on the TPU it groups same-shape batches into one dispatch, with
no numerical effect; the port dispatches each step alone.

`trainer.devices` / `trainer.mesh` give the `MeshSpec` of a data and graph
parallel run (`build_mesh_spec`); the scripts run it as one process per
rank (`torchrun --nproc-per-node N`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional

from matten_tpu_torch.train.trainer import TrainerConfig

__all__ = ["build_trainer_config", "build_mesh_spec", "MeshSpec"]

logger = logging.getLogger(__name__)

# class_path basename (case-insensitive) -> trainer optimizer kind
_OPTIMIZERS = {"adam": "adam", "adamw": "adamw", "sgd": "sgd"}
_PLATEAU_NAMES = {"reducelronplateau", "reduce_on_plateau", "plateau"}
_NONE_NAMES = {"none", "null", ""}


def _basename(class_path: str) -> str:
    return class_path.rsplit(".", 1)[-1].lower()


def _parse_optimizer(section: Optional[Dict[str, Any]]) -> str:
    """Map optimizer.class_path to a supported kind (default adam)."""
    cp = (section or {}).get("class_path")
    if cp is None:
        return "adam"
    kind = _OPTIMIZERS.get(_basename(str(cp)))
    if kind is None:
        raise ValueError(
            f"unsupported optimizer.class_path {cp!r}: the trainer implements "
            f"{sorted(set(_OPTIMIZERS))} (matched by class basename)"
        )
    return kind


def _parse_scheduler(section: Optional[Dict[str, Any]]) -> str:
    """Map lr_scheduler.class_path to 'plateau' | 'none'."""
    if section is None:
        return "plateau"
    cp = section.get("class_path")
    if cp is None or _basename(str(cp)) in _NONE_NAMES:
        return "none"
    if _basename(str(cp)) in _PLATEAU_NAMES:
        return "plateau"
    raise ValueError(
        f"unsupported lr_scheduler.class_path {cp!r}: the trainer implements "
        f"ReduceLROnPlateau (or none/null to disable)"
    )


def build_trainer_config(config: Dict[str, Any]) -> TrainerConfig:
    tr = config.get("trainer", {}) or {}
    opt_sec = config.get("optimizer") or {}
    sched_sec = config.get("lr_scheduler")
    opt = opt_sec.get("init_args", {}) or {}
    sched = (sched_sec or {}).get("init_args", {}) or {}
    cb = {c.get("class_path", ""): c.get("init_args", {}) for c in tr.get("callbacks", [])}
    early = next((v for k, v in cb.items() if "EarlyStopping" in k), {})
    ckpt = next((v for k, v in cb.items() if "ModelCheckpoint" in k), {})
    scan_steps = int(tr.get("scan_steps", 1))
    if scan_steps > 1:
        logger.info("trainer.scan_steps=%d is not used: the port dispatches each train step alone",
                    scan_steps)
    return TrainerConfig(
        max_epochs=tr.get("max_epochs", 10),
        lr=opt.get("lr", 0.01),
        weight_decay=opt.get("weight_decay", 1e-5),
        optimizer=_parse_optimizer(opt_sec),
        scheduler=_parse_scheduler(sched_sec),
        lr_factor=sched.get("factor", 0.5),
        lr_patience=sched.get("patience", 50),
        early_stopping_patience=early.get("patience", 150),
        save_top_k=ckpt.get("save_top_k", 3),
        checkpoint_dir=tr.get("checkpoint_dir", "checkpoints"),
        seed=config.get("seed_everything", 35),
        save_last_every_epochs=int(tr.get("save_last_every_epochs", 1)),
    )


@dataclass
class MeshSpec:
    """Parsed trainer.devices / trainer.mesh section."""

    n_data: int = 1
    n_graph: int = 1
    mode: str = "edge"  # edge | node | node_ring

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_graph

    @property
    def is_multichip(self) -> bool:
        return self.n_devices > 1

    def make_mesh(self):
        """This rank's mesh (`parallel.make_mesh`): every rank calls it."""
        from matten_tpu_torch.parallel.sharding import make_mesh

        return make_mesh(n_data=self.n_data, n_graph=self.n_graph, mode=self.mode)

    def loader_kwargs(self) -> Dict[str, Any]:
        """BatchLoader sharding knobs for this mesh layout."""
        return dict(
            num_shards=self.n_data,
            num_edge_shards=self.n_graph,
            node_shard=self.mode in ("node", "node_ring"),
            ring=self.mode == "node_ring",
        )


def build_mesh_spec(config: Dict[str, Any]) -> Optional[MeshSpec]:
    """trainer.devices / trainer.mesh -> MeshSpec (None = single device).

    `devices: N` alone is flat data parallelism; `mesh: {data, graph,
    mode}` adds the graph-partition axis. A `devices` that differs from the
    mesh's data * graph, or an unknown mode, raises."""
    tr = config.get("trainer", {}) or {}
    mesh = tr.get("mesh")
    if mesh:
        spec = MeshSpec(
            n_data=int(mesh.get("data", 1)),
            n_graph=int(mesh.get("graph", 1)),
            mode=str(mesh.get("mode", "edge")),
        )
        if spec.mode not in ("edge", "node", "node_ring"):
            raise ValueError(f"trainer.mesh.mode {spec.mode!r} not in edge|node|node_ring")
        devices = tr.get("devices")
        if devices is not None and int(devices) != spec.n_devices:
            raise ValueError(
                f"trainer.devices={devices} inconsistent with mesh data*graph={spec.n_devices}"
            )
        return spec if spec.is_multichip else None
    devices = int(tr.get("devices", 1) or 1)
    if devices > 1:
        return MeshSpec(n_data=devices)
    return None
