"""Symmetry-adapted Cartesian tensor <-> irreps change of basis.

Counterpart of `matten_tpu/ops/cartesian.py`. The basis is derived in numpy
float64 exactly as there (recursive coupling of k vector irreps with the
shared Wigner-3j tables, projection onto the formula's signed permutation
group, Schur reduction per isotypic block, Gram-Schmidt in index order), so
both packages hold the same basis; only the apply runs in torch.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.ops.irreps import Irrep, Irreps
from benchmark.reference.ops.clebsch_gordan import wigner_3j

__all__ = ["CartesianTensorMap", "cartesian_tensor_map"]


@functools.lru_cache(maxsize=None)
def _vector_power_decomposition(k: int):
    """Orthogonal decomposition of (R^3)^(x)k into irreps: a list of (l, p)
    per irrep copy and per-copy row blocks [2l+1, 3**k], all rows
    orthonormal."""
    if k == 0:
        return [(0, 1)], [np.ones((1, 1))]
    if k == 1:
        return [(1, -1)], [np.eye(3)]
    prev_entries, prev_blocks = _vector_power_decomposition(k - 1)
    entries: List[Tuple[int, int]] = []
    blocks: List[np.ndarray] = []
    for (l, p), b in zip(prev_entries, prev_blocks):
        for l3 in range(abs(l - 1), l + 2):
            c = wigner_3j(l, 1, l3)
            nb = np.sqrt(2 * l3 + 1) * np.einsum("mjn,my->njy", c, b)
            entries.append((l3, -p))
            blocks.append(nb.reshape(2 * l3 + 1, -1))
    return entries, blocks


def _formula_group(formula: str):
    """Signed permutation group generated by a symmetry formula."""
    terms = [t.strip() for t in formula.split("=")]
    first = terms[0]
    k = len(first)
    if len(set(first)) != k:
        raise ValueError(f"repeated index in formula {formula!r}")
    gens = []
    for t in terms[1:]:
        sign = 1
        if t.startswith("-"):
            sign = -1
            t = t[1:]
        if sorted(t) != sorted(first):
            raise ValueError(f"term {t!r} does not match indices of {first!r}")
        gens.append((tuple(first.index(ch) for ch in t), sign))
    identity = (tuple(range(k)), 1)
    group = {identity}
    frontier = [identity]
    while frontier:
        new = []
        for sigma1, s1 in frontier:
            for sigma2, s2 in gens:
                g = (tuple(sigma1[sigma2[i]] for i in range(k)), s1 * s2)
                if g not in group:
                    group.add(g)
                    new.append(g)
        frontier = new
    return k, sorted(group)


class CartesianTensorMap:
    """Orthonormal map between a symmetric Cartesian tensor space and irreps.

    Attributes:
        formula: the defining symmetry formula.
        rank: tensor rank k.
        irreps: the symmetry-adapted irreps (sorted by l, e.g. 2x0e+2x2e+4e).
        basis: [irreps.dim, 3^k] orthonormal change of basis (numpy float64).
    """

    def __init__(self, formula: str):
        self.formula = formula.lower()
        self._basis_on: Dict[Tuple[torch.dtype, torch.device], torch.Tensor] = {}
        k, group = _formula_group(self.formula)
        self.rank = k
        entries, blocks = _vector_power_decomposition(k)

        def project(row: np.ndarray) -> np.ndarray:
            t = row.reshape((3,) * k)
            acc = np.zeros_like(t)
            for sigma, sign in group:
                acc = acc + sign * np.transpose(t, axes=sigma)
            return (acc / len(group)).reshape(-1)

        out_entries: List[Tuple[int, int, np.ndarray]] = []
        seen = {}
        for idx, (l, p) in enumerate(entries):
            seen.setdefault((l, p), []).append(idx)
        for (l, p) in sorted(seen.keys()):
            idxs = seen[(l, p)]
            d = 2 * l + 1
            # Schur: the projector restricted to this isotypic block is
            # S (x) I_d with S[c, c'] = (1/d) sum_m <B_c[m], P B_c'[m]>
            projected = [np.stack([project(blocks[i][m]) for m in range(d)]) for i in idxs]
            s = np.zeros((len(idxs), len(idxs)))
            for c, i in enumerate(idxs):
                for cc in range(len(idxs)):
                    s[c, cc] = np.einsum("mx,mx->", blocks[i], projected[cc]) / d
            vecs = []
            for c in range(len(idxs)):
                v = s[:, c].copy()
                for u in vecs:
                    v -= (u @ v) * u
                n = np.linalg.norm(v)
                if n > 1e-8:
                    vecs.append(v / n)
            for u in vecs:
                rows = np.einsum("c,cmx->mx", u, np.stack(projected))
                nrm = np.linalg.norm(rows) / np.sqrt(d)
                out_entries.append((l, p, rows / nrm))

        self.irreps = Irreps([(1, Irrep(l, p)) for l, p, _ in out_entries]).simplify()
        if out_entries:
            self.basis = np.concatenate([rows for _, _, rows in out_entries], axis=0)
        else:
            self.basis = np.zeros((0, 3**k))
        gram = self.basis @ self.basis.T
        if np.abs(gram - np.eye(len(gram))).max() >= 1e-8:
            raise ValueError(f"non-orthonormal Cartesian basis for {formula!r}")

    @property
    def cartesian_shape(self) -> Tuple[int, ...]:
        return (3,) * self.rank

    def to_cartesian(self, x: torch.Tensor) -> torch.Tensor:
        """[..., irreps.dim] -> [..., 3, 3, ...] Cartesian tensor."""
        # the basis copied to each (dtype, device) once: a copy per call would
        # wait on the card, and a captured step cannot make it; made outside
        # inference mode, so a later forward with gradients can save it
        q = self._basis_on.get((x.dtype, x.device))
        if q is None:
            with torch.inference_mode(False):
                q = torch.as_tensor(self.basis, dtype=x.dtype, device=x.device)
            self._basis_on[x.dtype, x.device] = q
        return (x @ q).reshape(x.shape[:-1] + self.cartesian_shape)

    def __repr__(self) -> str:
        return f"CartesianTensorMap({self.formula!r} -> {self.irreps})"


@functools.lru_cache(maxsize=None)
def cartesian_tensor_map(formula: str) -> CartesianTensorMap:
    return CartesianTensorMap(formula)
