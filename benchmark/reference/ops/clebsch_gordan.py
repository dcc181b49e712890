"""The Clebsch-Gordan blocks the port's modules use.

`wigner_3j` is `ops.wigner.wigner_3j` (the reference package's computation,
kept as an exact copy) wherever that converges. Its null space comes from
an SVD, which some OpenBLAS builds fail to converge for single triples at
some thread counts: (2, 4, 4) at one thread and (4, 4, 8) at three, with
OpenBLAS 0.3.27, and one thread is what `torchrun` sets through
`OMP_NUM_THREADS` when it starts more than one rank. There the same null
space is taken from the eigenvectors of the invariance conditions' Gram
matrix (float64 `eigh`, which has no convergence failure of that kind),
normalized and signed as the reference does.
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.reference.ops import wigner

__all__ = ["wigner_3j"]

# eigenvalues of the Gram matrix below this are its null space: for every
# triple up to l = 4 x 4 -> 8 the null eigenvalue is below 1e-12 in float64
# and the next one is 2
NULL_EIGENVALUE = 1e-6


@functools.lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Rotation-invariant 3-tensor C[m1, m2, m3], Frobenius norm 1 (see
    `ops.wigner.wigner_3j`), computed without an SVD where that fails."""
    try:
        return wigner.wigner_3j(l1, l2, l3)
    except np.linalg.LinAlgError:
        return _wigner_3j_by_eigh(l1, l2, l3)


def _wigner_3j_by_eigh(l1: int, l2: int, l3: int) -> np.ndarray:
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    k1, k2, k3 = wigner.generators(l1), wigner.generators(l2), wigner.generators(l3)
    i1, i2, i3 = np.eye(d1), np.eye(d2), np.eye(d3)
    gram = np.zeros((d1 * d2 * d3,) * 2)
    for a in range(3):
        m = (
            np.einsum("ij,kl,mn->ikmjln", k1[a], i2, i3)
            + np.einsum("ij,kl,mn->ikmjln", i1, k2[a], i3)
            + np.einsum("ij,kl,mn->ikmjln", i1, i2, k3[a])
        ).reshape(d1 * d2 * d3, d1 * d2 * d3)
        gram += m.T @ m
    evals, evecs = np.linalg.eigh(gram)
    basis = evecs[:, evals < NULL_EIGENVALUE]
    assert basis.shape[1] == 1, (
        f"invariant subspace of ({l1},{l2},{l3}) has dim {basis.shape[1]}, expected 1"
    )
    c = basis[:, 0] / np.linalg.norm(basis[:, 0])
    idx = np.argmax(np.abs(c) > 1e-8)
    if c[idx] < 0:
        c = -c
    c[np.abs(c) < 1e-14] = 0.0
    return c.reshape(d1, d2, d3)
