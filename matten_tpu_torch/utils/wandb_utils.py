"""Optional Weights & Biases experiment utilities (no-op without wandb).

Counterpart of `matten_tpu/utils/wandb_utils.py`, a copy of that pure-Python
module: run metadata capture (cwd, hostname, git commit), a metric logger
that writes wandb when it is installed and configured and a JSONL file
otherwise, and the checkpoint-directory lookup by run identifier. `wandb`
is imported only inside `wandb_available()` and the logger.
"""

from __future__ import annotations

import json
import logging
import socket
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = [
    "wandb_available",
    "write_running_metadata",
    "WandbLogger",
    "get_wandb_run_path",
    "get_wandb_checkpoint_path",
    "get_wandb_identifier",
    "get_wandb_checkpoint_and_identifier_latest",
]


def wandb_available() -> bool:
    try:
        import wandb  # noqa: F401

        return True
    except ImportError:
        return False


def _git_commit(repo_path: str = ".") -> Optional[str]:
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"],
                cwd=repo_path,
                capture_output=True,
                text=True,
                check=True,
            ).stdout.strip()
        )
    except Exception:  # noqa: BLE001
        return None


def write_running_metadata(path: str = "running_metadata.json") -> Dict:
    """Capture cwd/hostname/git-commit (reference utils_wandb.py:44-70)."""
    meta = {
        "cwd": str(Path.cwd()),
        "hostname": socket.gethostname(),
        "git_commit": _git_commit(),
    }
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class WandbLogger:
    """Metric logger: wandb when available+configured, JSONL file otherwise."""

    def __init__(
        self,
        project: Optional[str] = None,
        save_dir: str = "matten_tpu_logs",
        config: Optional[Dict] = None,
        enabled: bool = True,
        checkpoint_dir: Optional[str] = None,
    ):
        self._run = None
        self._jsonl = None
        self.run_id: Optional[str] = None
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        if enabled and project and wandb_available():
            import wandb

            self._run = wandb.init(project=project, dir=save_dir, config=config)
            self.run_id = self._run.id
        else:
            self._jsonl = open(Path(save_dir) / "metrics.jsonl", "a")
            if config:
                with open(Path(save_dir) / "config.json", "w") as f:
                    json.dump(config, f, indent=2, default=str)
            import time as _time
            import uuid as _uuid

            self.run_id = _uuid.uuid4().hex[:8]
            stamp = _time.strftime("%Y%m%d_%H%M%S")
            run_dir = Path(save_dir) / "wandb" / f"run-{stamp}-{self.run_id}"
            run_dir.mkdir(parents=True, exist_ok=True)
            with open(run_dir / "info.json", "w") as f:
                json.dump(
                    {
                        "id": self.run_id,
                        "checkpoint_dir": str(Path(checkpoint_dir).resolve())
                        if checkpoint_dir
                        else None,
                        "project": project,
                    },
                    f,
                    indent=2,
                )
            latest = Path(save_dir) / "wandb" / "latest-run"
            try:
                if latest.is_symlink() or latest.exists():
                    latest.unlink()
                latest.symlink_to(run_dir.name)
            except OSError:  # filesystems without symlinks: write a marker
                with open(Path(save_dir) / "wandb" / "latest-run.txt", "w") as f:
                    f.write(run_dir.name)

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)
        elif self._jsonl is not None:
            rec = dict(metrics)
            if step is not None:
                rec["step"] = step
            self._jsonl.write(json.dumps(rec, default=float) + "\n")
            self._jsonl.flush()

    def save_files(self, paths: Sequence[str]) -> None:
        if self._run is not None:
            import wandb

            for p in paths:
                wandb.save(p)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
        if self._jsonl is not None:
            self._jsonl.close()


# ---- restore-by-run-identifier helpers (reference utils_wandb.py:99-207) --


def get_wandb_run_path(identifier: str, path="."):
    """Find the run directory for a run identifier (reference
    utils_wandb.py:99-120): any `run-*-<identifier>` / `offline-run-*`
    directory under a `wandb` folder below `path`."""
    import os

    for root, dirs, _ in os.walk(path):
        for d in dirs:
            if (d.startswith("run-") or d.startswith("offline-run-")) and d.split(
                "-"
            )[-1] == identifier:
                return str(Path(root, d).resolve())
    raise RuntimeError(f"Cannot find run {identifier} in {path}")


def get_wandb_checkpoint_path(identifier: str, path=".") -> Optional[str]:
    """Checkpoint directory for a run identifier (reference
    utils_wandb.py:122-138): the run dir's recorded checkpoint_dir, or any
    `<identifier>/checkpoints` directory below `path`."""
    import os

    try:
        run_dir = get_wandb_run_path(identifier, path)
        info = Path(run_dir) / "info.json"
        if info.exists():
            ckpt = json.loads(info.read_text()).get("checkpoint_dir")
            if ckpt and Path(ckpt).exists():
                return str(Path(ckpt).resolve())
    except RuntimeError:
        pass
    for root, _, _ in os.walk(path):
        if root.endswith(f"{identifier}/checkpoints"):
            return str(Path(root).resolve())
    return None


def get_wandb_identifier(save_dir, run_directory: str = "latest-run") -> Optional[str]:
    """Run identifier of a (by default the latest) run under save_dir
    (reference utils_wandb.py:155-174)."""
    d = Path(save_dir) / "wandb" / run_directory
    marker = Path(save_dir) / "wandb" / "latest-run.txt"
    if d.is_symlink() or d.exists():
        return str(d.resolve()).split("-")[-1]
    if run_directory == "latest-run" and marker.exists():
        return marker.read_text().strip().split("-")[-1]
    return None


def get_wandb_checkpoint_and_identifier_latest(
    save_dir, run_directory: str = "latest-run"
):
    """(path to the `last` checkpoint, run identifier) of the latest run
    (reference utils_wandb.py:177-207) — the restore hand-off used to
    continue a crashed run located only by its W&B/log directory."""
    identifier = get_wandb_identifier(save_dir, run_directory)
    if not identifier:
        return None, None
    ckpt_dir = get_wandb_checkpoint_path(identifier, save_dir)
    if ckpt_dir is None:
        # the checkpoint dir may live outside save_dir (recorded path only)
        try:
            run_dir = get_wandb_run_path(identifier, save_dir)
            info = Path(run_dir) / "info.json"
            if info.exists():
                ckpt_dir = json.loads(info.read_text()).get("checkpoint_dir")
        except RuntimeError:
            ckpt_dir = None
    if not ckpt_dir:
        return None, None
    last = Path(ckpt_dir) / "last"
    return (str(last) if last.exists() else None), identifier
