"""Real spherical harmonics from the framework's own CG tables.

Counterpart of `matten_tpu/ops/spherical_harmonics.py`, with the same
recursion and constants: Y_0 = 1, Y_1(r) = r in (x, y, z) order, and
Y_l = c_l * <w3j(l-1, 1, l), Y_{l-1}, Y_1>, with c_l chosen so that
||Y_l||^2 = 2l+1 on the unit sphere ("component" normalization).
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch

from benchmark.reference.ops.irreps import Irreps
from benchmark.reference.ops.clebsch_gordan import wigner_3j

__all__ = ["spherical_harmonics", "sh_irreps"]


def sh_irreps(lmax: int) -> Irreps:
    return Irreps.spherical_harmonics(lmax)


@functools.lru_cache(maxsize=None)
def _sh_constants(lmax: int) -> tuple:
    """Per-degree scale constants for component normalization (float64)."""
    v = np.array([0.2672612419124244, -0.5345224838248488, 0.8017837257372732])
    v = v / np.linalg.norm(v)
    ys = [np.ones(1), v.copy()]
    consts = [1.0, np.sqrt(3.0)]
    for l in range(2, lmax + 1):
        raw = np.einsum("i,j,ijk->k", ys[-1], v, wigner_3j(l - 1, 1, l))
        scale = np.sqrt(2 * l + 1) / np.linalg.norm(raw)
        ys.append(raw * scale)
        consts.append(scale)
    return tuple(consts)


@functools.lru_cache(maxsize=None)
def _recursion_table(l: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """c_l * w3j(l-1, 1, l) on `device`, copied there once (a copy per call
    would sync the host with the card in every forward). Made outside
    inference mode even when the first call is in it: a later forward that
    needs position gradients saves the table for its backward, which an
    inference tensor refuses."""
    with torch.inference_mode(False):
        return torch.as_tensor(wigner_3j(l - 1, 1, l) * _sh_constants(l)[l], dtype=dtype, device=device)


def _degrees(lmax_or_irreps: Union[int, Irreps, str, Sequence[int]]) -> list:
    if isinstance(lmax_or_irreps, int):
        return list(range(lmax_or_irreps + 1))
    irreps = Irreps(lmax_or_irreps)
    ls = []
    for mul, ir in irreps:
        if mul != 1:
            raise ValueError(f"SH irreps must have multiplicity 1, got {irreps}")
        if ir.p != (-1) ** ir.l:
            raise ValueError(f"SH irreps must have natural parity, got {irreps}")
        ls.append(ir.l)
    if ls != sorted(ls):
        raise ValueError(f"SH irreps must be in ascending l order, got {irreps}")
    return ls


def spherical_harmonics(
    lmax_or_irreps: Union[int, Irreps, str, Sequence[int]], vectors: torch.Tensor
) -> torch.Tensor:
    """Component-normalized real spherical harmonics of the unit vectors
    along `vectors` ([..., 3], (x, y, z)).

    Returns [..., sum(2l+1)] concatenated over the requested degrees. The
    zero vector maps to Y_0 = 1 and zeros above.
    """
    ls = _degrees(lmax_or_irreps)
    lmax = max(ls)
    consts = _sh_constants(lmax)

    n = torch.linalg.norm(vectors, dim=-1, keepdim=True)
    v = vectors / torch.where(n > 0, n, torch.ones_like(n))
    ys = [torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device), v]
    for l in range(2, lmax + 1):
        c = _recursion_table(l, v.dtype, v.device)
        ys.append(torch.einsum("...i,...j,ijk->...k", ys[-1], v, c))
    ys[1] = ys[1] * consts[1]
    return torch.cat([ys[l] for l in ls], dim=-1)
