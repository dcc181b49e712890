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
interleaves) fails loudly instead of loading wrong weights.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["flax_to_state_dict"]


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
        out[key] = torch.as_tensor(np.ascontiguousarray(value), dtype=target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model entries with no flax leaf: {missing}")
    return out
