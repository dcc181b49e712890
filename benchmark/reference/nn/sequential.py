"""Irreps-checked sequential container.

Counterpart of `matten_tpu/nn/sequential.py`: consecutive dict-passing
modules are checked at build time so that each one's declared outputs cover
the next one's inputs with matching irreps.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def validate_chain(modules: Sequence[torch.nn.Module]) -> None:
    """Check irreps compatibility of consecutive dict-passing modules.
    Modules that declare no irreps (`DetectAnomaly`, which passes the dict
    through unchanged) are left out."""
    modules = [m for m in modules if hasattr(m, "irreps_in") and hasattr(m, "irreps_out")]
    for a, b in zip(modules[:-1], modules[1:]):
        out_d, in_d = a.irreps_out, b.irreps_in
        for key, ir in in_d.items():
            if key not in out_d:
                raise ValueError(
                    f"{type(b).__name__} requires field {key!r} not produced by "
                    f"{type(a).__name__}"
                )
            if ir is not None and out_d[key] is not None:
                if tuple(out_d[key].simplify()) != tuple(ir.simplify()):
                    raise ValueError(
                        f"irreps mismatch on {key!r}: {type(a).__name__} gives "
                        f"{out_d[key]}, {type(b).__name__} expects {ir}"
                    )


class Sequential(torch.nn.Module):
    """Runs `layers` in order on the data dict. Children are named by
    position (`layers.0`, `layers.1`, ...), like the flax `layers_i`."""

    def __init__(self, layers: Sequence[torch.nn.Module]):
        super().__init__()
        validate_chain(layers)
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for layer in self.layers:
            data = layer(data)
        return data
