"""Carry trained flax variables of the JAX model over to the port.

`flax_to_state_dict` takes the flax variables ({"params": ...,
"batch_stats": ...}) as a nested dict of numpy arrays — e.g. an orbax
restore converted with `np.asarray` — and returns the `state_dict` of the
port's model. It imports no JAX. The JAX Sequential names its children by
position (`layers_0`, `layers_1`, ...), which maps onto the port's
`layers.0`, `layers.1`, ...; flax Dense kernels are [in, out] and become
`torch.nn.Linear` weights [out, in]. Every flax leaf must land on exactly
one model entry of the same shape and every entry must be filled, so a
shifted layer index (e.g. the DEBUG-level anomaly layers the JAX factory
interleaves) fails loudly instead of loading wrong weights. Both model
families convert: the graph-level tree ends in the head's `w_out` (and, for
a multi-task model, one `w_{name}` per scalar head beside it), the per-atom
tree in the backbone's NodewiseLinear head; an instance norm's `weight` and
`bias` sit under its conv layer's `norm`, as a batch norm's do.

`convert_checkpoint` turns a model trained with the JAX package into a
checkpoint directory of the port, which `predict(structures, directory)`
serves on the card: the caller restores the flax variables (e.g. with
orbax, on a machine that has it) and passes them with the JAX sidecar's
hparams and statistics arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "convert_checkpoint"]


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _torch_key(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path[1:]:  # drop the collection ("params" / "batch_stats")
        if p.startswith("layers_") and p[len("layers_"):].isdigit():
            parts += ["layers", p[len("layers_"):]]
        elif p == "kernel":
            parts.append("weight")
        else:
            parts.append(p)
    return ".".join(parts)


def flax_to_state_dict(
    variables: Mapping, model: torch.nn.Module
) -> Dict[str, torch.Tensor]:
    """Map flax variables onto `model`'s state_dict keys (checked 1:1)."""
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables):
        key = _torch_key(path)
        if path[-1] == "kernel":
            value = value.T
        if key not in target:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {key!r} has no counterpart in the model")
        if key in out:
            raise KeyError(f"two flax leaves map onto {key!r}")
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{'/'.join(path)}: shape {value.shape} != model {tuple(target[key].shape)}"
            )
        out[key] = torch.as_tensor(np.array(value, order="C"), dtype=target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model entries with no flax leaf: {missing}")
    return out


def convert_checkpoint(
    variables: Mapping,
    hparams: Dict[str, Any],
    statistics_arrays: Dict[str, np.ndarray],
    out_dir: Union[str, Path],
) -> Path:
    """Write a port checkpoint directory for trained flax variables.

    `hparams` and `statistics_arrays` are the JAX checkpoint's sidecars
    (`load_sidecar`): they pick the model family and rebuild it on the CPU;
    the variables are mapped onto it with `flax_to_state_dict` and saved as
    the directory's `last` state next to copies of the sidecars. Returns
    the directory."""
    from matten_tpu_torch.predict import model_from_sidecar
    from matten_tpu_torch.train.checkpoint import CheckpointManager, save_sidecar

    model, _, _ = model_from_sidecar(hparams, statistics_arrays, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, model))
    save_sidecar(out_dir, hparams, statistics_arrays)
    CheckpointManager(out_dir).save_last({"model": model.state_dict()})
    return Path(out_dir)
