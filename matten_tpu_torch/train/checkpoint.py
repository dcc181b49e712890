"""Checkpointing: best-k + last train states with torch.save, with sidecars.

Counterpart of `matten_tpu/train/checkpoint.py`. The directory layout and
the sidecars are the JAX package's: `hparams.json` (the `model`, `data`,
`dataset_hparams` and `normalize_tensor_target` a model is rebuilt from),
`dataset_statistics.npz`, `index.json` (the best-k epochs by `val/score`),
`last/` and `loop_state.json`. The saved state is torch's own:
`epoch_<n>/state.pt` and `last/state.pt` hold the dict `Trainer.state_dict`
gives (the model's `state_dict` with the batch-norm running statistics, the
optimizer's, the plateau scheduler's fields), written with `torch.save` and
read back with `torch.load(..., weights_only=True)`.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_sidecar", "load_sidecar"]

STATE_FILE = "state.pt"


def save_sidecar(directory, hparams: Dict[str, Any], statistics_arrays: Dict[str, np.ndarray]):
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "hparams.json", "w") as f:
        json.dump(hparams, f, indent=2, default=str)
    np.savez(directory / "dataset_statistics.npz", **statistics_arrays)


def load_sidecar(directory):
    directory = Path(directory)
    with open(directory / "hparams.json") as f:
        hparams = json.load(f)
    stats_path = directory / "dataset_statistics.npz"
    stats = dict(np.load(stats_path)) if stats_path.exists() else {}
    return hparams, stats


class CheckpointManager:
    """Best-k (min val/score) + last checkpoints in `directory`.

    `writer=False` keeps the best-k bookkeeping of `save` and writes
    nothing: the other ranks of a multi-process fit, whose primary rank
    writes the directory and all of which read it back."""

    def __init__(self, directory, save_top_k: int = 3, writer: bool = True):
        self.directory = Path(directory).absolute()
        self.writer = writer
        if writer:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self._scores: Dict[int, float] = {}
        if self._index_path().exists():
            with open(self._index_path()) as f:
                self._scores = {int(k): float(v) for k, v in json.load(f).items()}

    def _index_path(self) -> Path:
        return self.directory / "index.json"

    def _epoch_dir(self, epoch: int) -> Path:
        return self.directory / f"epoch_{epoch}"

    @staticmethod
    def _write(path: Path, state: Dict[str, Any]) -> None:
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(state, path / STATE_FILE)

    def save(self, epoch: int, state: Dict[str, Any], metrics: Dict[str, float]):
        """Save an epoch's state, then keep only the best `save_top_k`."""
        if self.writer:
            self._write(self._epoch_dir(epoch), state)
        self._scores[epoch] = float(metrics.get("val/score", float("inf")))
        if len(self._scores) > self.save_top_k:
            worst = max(self._scores, key=self._scores.get)
            self._scores.pop(worst)
            if self.writer:
                shutil.rmtree(self._epoch_dir(worst), ignore_errors=True)
        if self.writer:
            with open(self._index_path(), "w") as f:
                json.dump(self._scores, f)

    def save_last(self, state: Dict[str, Any], loop_state: Optional[Dict[str, Any]] = None):
        """Save the rolling `last` checkpoint (+ training-loop state): a
        crash resumes from the latest epoch with the optimizer, scheduler and
        early-stopping positions intact. Both writes are atomic: the state
        goes to `last_tmp` and is renamed, the loop state to a temporary
        file that replaces the old one."""
        if not self.writer:
            return
        tmp = self.directory / "last_tmp"
        self._write(tmp, state)
        path = self.directory / "last"
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)
        if loop_state is not None:
            ltmp = self.directory / "loop_state.json.tmp"
            with open(ltmp, "w") as f:
                json.dump(loop_state, f)
            os.replace(ltmp, self.directory / "loop_state.json")

    def load_loop_state(self) -> Optional[Dict[str, Any]]:
        p = self.directory / "loop_state.json"
        if not p.exists():
            return None
        try:
            with open(p) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            # corrupt sidecar (crash between `last` rename and the loop-state
            # write): fall back to a state-only resume
            return None

    def has_last(self) -> bool:
        return (self.directory / "last").exists()

    @property
    def best_epoch(self) -> Optional[int]:
        if not self._scores:
            return None
        return min(self._scores, key=self._scores.get)

    def restore(
        self,
        epoch: Optional[int] = None,
        last: bool = False,
        device: Union[str, torch.device, None] = None,
    ) -> Dict[str, Any]:
        """The saved state of `epoch` (default: the best), or of `last`, with
        its tensors on `device` (default: where they were saved)."""
        if last:
            path = self.directory / "last"
        else:
            epoch = epoch if epoch is not None else self.best_epoch
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
            path = self._epoch_dir(epoch)
        return torch.load(path / STATE_FILE, weights_only=True, map_location=device)
