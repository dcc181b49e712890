"""Wigner machinery for O(3), derived from scratch.

This module re-derives — with no e3nn dependency — the static tables the
reference framework gets from e3nn (`o3.wigner_3j`, irrep rotation
matrices; consumed at reference nn/utils.py:230 via TensorProduct and
tests/model/test_tfn_tensor.py:71-95 via rotations):

  * real so(3) generators K_x,K_y,K_z for every degree l,
  * Wigner 3j tensors C[m1,m2,m3] as the (1-dim) rotation-invariant
    subspace of V_l1 (x) V_l2 (x) V_l3, computed as the nullspace of the
    infinitesimal-invariance equations,
  * irrep rotation matrices D^l(R) by exponentiating the generators.

Basis convention (fixes all downstream conventions of the framework):
  * l=1 is stored in coordinate order (x, y, z), so the degree-1 generators
    are the classical cross-product matrices (K_a)_{ij} = -eps_{aij} and the
    l=1 Wigner D matrix of a rotation R is R itself.
  * l != 1 uses the standard real-spherical-harmonic order m = -l..l.
  * Everything is derived from the generators, so any consumer (3j tables,
    spherical harmonics, Cartesian change-of-basis) is automatically
    consistent with this choice.

All computation here is trace-time numpy float64 and cached.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "generators",
    "wigner_3j",
    "rotation_matrix",
    "irrep_rotation",
    "random_rotation",
]


def _complex_angular_momentum(l: int) -> np.ndarray:
    """L_x, L_y, L_z in the complex |l,m> basis, m = -l..l. Shape [3, d, d]."""
    m = np.arange(-l, l + 1)
    d = 2 * l + 1
    lz = np.diag(m).astype(np.complex128)
    # raising operator: L+ |m> = sqrt(l(l+1) - m(m+1)) |m+1>
    lp = np.zeros((d, d), dtype=np.complex128)
    for i in range(d - 1):
        mm = m[i]
        lp[i + 1, i] = np.sqrt(l * (l + 1) - mm * (mm + 1))
    lm = lp.conj().T
    lx = (lp + lm) / 2.0
    ly = (lp - lm) / 2.0j
    return np.stack([lx, ly, lz])


def _real_from_complex(l: int) -> np.ndarray:
    """Unitary Q with Y^real = Q @ Y^complex (standard real SH, Condon-Shortley).

    Rows indexed by real m = -l..l, columns by complex m = -l..l.
    """
    d = 2 * l + 1
    q = np.zeros((d, d), dtype=np.complex128)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            q[i, m + l] = 1j / np.sqrt(2)
            q[i, -m + l] = -1j * (-1) ** m / np.sqrt(2)
        elif m == 0:
            q[i, l] = 1.0
        else:
            q[i, -m + l] = 1.0 / np.sqrt(2)
            q[i, m + l] = (-1) ** m / np.sqrt(2)
    return q


# permutation: standard real-SH l=1 order (m=-1,0,1) = (y, z, x)  ->  (x, y, z)
_XYZ_FROM_YZX = np.array(
    [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
)


@functools.lru_cache(maxsize=None)
def generators(l: int) -> np.ndarray:
    """Real antisymmetric so(3) generators [3, 2l+1, 2l+1] for degree l.

    Satisfy [K_x, K_y] = K_z (cyclically). For l=1 these are exactly the
    cross-product matrices acting on (x, y, z).
    """
    if l == 0:
        return np.zeros((3, 1, 1))
    if l == 1:
        k = np.zeros((3, 3, 3))
        eps = np.zeros((3, 3, 3))
        eps[0, 1, 2] = eps[1, 2, 0] = eps[2, 0, 1] = 1.0
        eps[0, 2, 1] = eps[1, 0, 2] = eps[2, 1, 0] = -1.0
        for a in range(3):
            k[a] = -eps[a]
        return k
    ls = _complex_angular_momentum(l)
    q = _real_from_complex(l)
    ks = []
    for a in range(3):
        ka = q @ (-1j * ls[a]) @ q.conj().T
        assert np.abs(ka.imag).max() < 1e-12, f"generator not real for l={l}"
        ks.append(ka.real)
    k = np.stack(ks)
    # verify so(3) commutation relations (sign conventions matter downstream)
    for a in range(3):
        b, c = (a + 1) % 3, (a + 2) % 3
        comm = k[a] @ k[b] - k[b] @ k[a]
        assert np.abs(comm - k[c]).max() < 1e-10, f"[K{a},K{b}] != K{c} for l={l}"
    return k


@functools.lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Rotation-invariant 3-tensor C[m1, m2, m3], Frobenius norm 1.

    Nonzero iff |l1-l2| <= l3 <= l1+l2. Computed as the nullspace of the
    infinitesimal invariance conditions  (K_a acting on any slot) C = 0.
    Sign fixed deterministically (first significant entry positive).
    """
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((d1, d2, d3))
    k1, k2, k3 = generators(l1), generators(l2), generators(l3)
    i1, i2, i3 = np.eye(d1), np.eye(d2), np.eye(d3)
    rows = []
    for a in range(3):
        m = (
            np.einsum("ij,kl,mn->ikmjln", k1[a], i2, i3)
            + np.einsum("ij,kl,mn->ikmjln", i1, k2[a], i3)
            + np.einsum("ij,kl,mn->ikmjln", i1, i2, k3[a])
        ).reshape(d1 * d2 * d3, d1 * d2 * d3)
        rows.append(m)
    m = np.concatenate(rows, axis=0)
    # nullspace via SVD
    _, s, vt = np.linalg.svd(m)
    null_mask = np.concatenate([s, np.zeros(vt.shape[0] - len(s))]) < 1e-9
    basis = vt[null_mask]
    assert basis.shape[0] == 1, (
        f"invariant subspace of ({l1},{l2},{l3}) has dim {basis.shape[0]}, expected 1"
    )
    c = basis[0]
    c = c / np.linalg.norm(c)
    # deterministic sign: first entry with non-negligible magnitude is positive
    idx = np.argmax(np.abs(c) > 1e-8)
    if c[idx] < 0:
        c = -c
    c[np.abs(c) < 1e-14] = 0.0
    return c.reshape(d1, d2, d3)


def rotation_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """3x3 rotation about `axis` by `angle` (Rodrigues)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    kx = np.einsum("aij,a->ij", generators(1), axis)
    return (
        np.eye(3) + np.sin(angle) * kx + (1.0 - np.cos(angle)) * (kx @ kx)
    )


def irrep_rotation(l: int, p: int, r: np.ndarray) -> np.ndarray:
    """Wigner D matrix of the O(3) element `r` (3x3 orthogonal) on irrep (l, p).

    For improper r (det < 0), factor out the inversion: D = p * D_l(-r)... i.e.
    D(r) = (p if det(r)<0 else 1) * D_l(r_proper).
    """
    from scipy.linalg import expm, logm

    r = np.asarray(r, dtype=np.float64)
    det = np.linalg.det(r)
    parity_factor = 1.0
    r_proper = r
    if det < 0:
        r_proper = -r
        parity_factor = float(p)
    if l == 0:
        return parity_factor * np.ones((1, 1))
    if l == 1:
        return parity_factor * r_proper
    # axis-angle of the proper rotation
    w = logm(r_proper)
    w = np.real(w)
    vec = np.array([w[2, 1] - w[1, 2], w[0, 2] - w[2, 0], w[1, 0] - w[0, 1]]) / 2.0
    angle = np.linalg.norm(vec)
    k = generators(l)
    if angle < 1e-12:
        return parity_factor * np.eye(2 * l + 1)
    axis = vec / angle
    return parity_factor * expm(angle * np.einsum("aij,a->ij", k, axis))


def random_rotation(rng: np.random.Generator, improper: bool = False) -> np.ndarray:
    """Haar-ish random 3x3 rotation (optionally composed with inversion)."""
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    if improper:
        q = -q
    return q


def irreps_rotation(irreps, r: np.ndarray) -> np.ndarray:
    """Block-diagonal rotation matrix on a full Irreps feature vector."""
    from benchmark.reference.ops.irreps import Irreps

    irreps = Irreps(irreps)
    blocks = []
    for mul, ir in irreps:
        d = irrep_rotation(ir.l, ir.p, r)
        for _ in range(mul):
            blocks.append(d)
    n = sum(b.shape[0] for b in blocks)
    out = np.zeros((n, n))
    i = 0
    for b in blocks:
        out[i : i + b.shape[0], i : i + b.shape[0]] = b
        i += b.shape[0]
    return out
