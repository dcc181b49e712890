"""Irreps-dict helpers shared by the dict-passing modules.

Counterpart of `matten_tpu/nn/common.py`. Every module declares
`irreps_in` / `irreps_out` as {field: Irreps or None} dicts (None marks an
invariant index or mask field) so a model's CG tables are fixed when it is
built.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from benchmark.reference.ops.irreps import Irreps

IrrepsDict = Dict[str, Optional[Irreps]]


def irreps_dict(mapping: Optional[Mapping]) -> IrrepsDict:
    """Normalize a {field: irreps-like} mapping."""
    if mapping is None:
        return {}
    return {k: None if v is None else Irreps(v) for k, v in dict(mapping).items()}


def merge_irreps(irreps_in: Mapping, updates: Mapping) -> IrrepsDict:
    d = irreps_dict(irreps_in)
    d.update(irreps_dict(updates))
    return d


def check_required(irreps_in: Mapping, required: Sequence[str], who: str) -> None:
    for k in required:
        if k not in irreps_in:
            raise ValueError(f"{who}: required input field {k!r} missing from irreps_in")


def normal_parameter(n: int, generator: torch.Generator) -> torch.nn.Parameter:
    """Flat N(0, 1) weights — the e3nn convention (variance carried by the
    forward-pass scaling, not by init)."""
    return torch.nn.Parameter(torch.randn(n, generator=generator))
