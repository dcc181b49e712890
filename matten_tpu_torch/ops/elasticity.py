"""Elasticity tensor utilities: Voigt notation + derived moduli.

Own equivalent of the pymatgen `ElasticTensor` wrap the reference applies to
its predictions (reference predict.py:217-218): converts the raw rank-4
stiffness tensor to 6x6 Voigt notation and exposes the standard
Voigt/Reuss/Hill polycrystalline averages. Implemented as an `np.ndarray`
subclass (like pymatgen's Tensor) so existing consumers that treat the
prediction as a plain [3,3,3,3] array keep working unchanged.

Conventions (standard): Voigt index pairs 0:(0,0) 1:(1,1) 2:(2,2) 3:(1,2)
4:(0,2) 5:(0,1); the stiffness C maps to Voigt without scale factors; the
compliance S = C_voigt^-1 carries the usual factors implicitly through the
inversion, and the Reuss formulas below are written directly in terms of
S_voigt entries.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ElasticTensor", "full_to_voigt", "voigt_to_full"]

# Voigt pair for each of the 6 indices
_VOIGT_PAIRS = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]
# inverse map (i, j) -> Voigt index
_PAIR_TO_VOIGT = np.zeros((3, 3), dtype=int)
for _I, (_i, _j) in enumerate(_VOIGT_PAIRS):
    _PAIR_TO_VOIGT[_i, _j] = _I
    _PAIR_TO_VOIGT[_j, _i] = _I


def full_to_voigt(c: np.ndarray) -> np.ndarray:
    """[3,3,3,3] stiffness -> [6,6] Voigt matrix (no scale factors)."""
    c = np.asarray(c)
    assert c.shape[-4:] == (3, 3, 3, 3), c.shape
    v = np.empty(c.shape[:-4] + (6, 6), dtype=c.dtype)
    for a, (i, j) in enumerate(_VOIGT_PAIRS):
        for b, (k, l) in enumerate(_VOIGT_PAIRS):
            v[..., a, b] = c[..., i, j, k, l]
    return v


def voigt_to_full(v: np.ndarray) -> np.ndarray:
    """[6,6] Voigt stiffness -> [3,3,3,3] with full minor symmetries."""
    v = np.asarray(v)
    assert v.shape[-2:] == (6, 6), v.shape
    c = np.empty(v.shape[:-2] + (3, 3, 3, 3), dtype=v.dtype)
    for i in range(3):
        for j in range(3):
            for k in range(3):
                for l in range(3):
                    c[..., i, j, k, l] = v[
                        ..., _PAIR_TO_VOIGT[i, j], _PAIR_TO_VOIGT[k, l]
                    ]
    return c


class ElasticTensor(np.ndarray):
    """Rank-4 stiffness tensor with Voigt view and polycrystalline moduli.

    Behaves exactly like the underlying [3,3,3,3] float array (it *is* one);
    adds `.voigt`, Voigt/Reuss/Hill bulk & shear moduli, Young's modulus and
    Poisson ratio — the properties reference users get from pymatgen's
    ElasticTensor. Units follow the training data (GPa for the matten set).
    """

    def __new__(cls, input_array):
        obj = np.asarray(input_array, dtype=np.float64)
        if obj.shape != (3, 3, 3, 3):
            raise ValueError(f"ElasticTensor must be [3,3,3,3], got {obj.shape}")
        return obj.view(cls)

    @classmethod
    def from_voigt(cls, v: np.ndarray) -> "ElasticTensor":
        return cls(voigt_to_full(v))

    @property
    def voigt(self) -> np.ndarray:
        return full_to_voigt(np.asarray(self))

    @property
    def compliance_voigt(self) -> np.ndarray:
        return np.linalg.inv(self.voigt)

    # --- polycrystalline averages -------------------------------------
    @property
    def k_voigt(self) -> float:
        c = self.voigt
        return float(
            (c[0, 0] + c[1, 1] + c[2, 2] + 2 * (c[0, 1] + c[0, 2] + c[1, 2])) / 9.0
        )

    @property
    def g_voigt(self) -> float:
        c = self.voigt
        return float(
            (
                (c[0, 0] + c[1, 1] + c[2, 2])
                - (c[0, 1] + c[0, 2] + c[1, 2])
                + 3 * (c[3, 3] + c[4, 4] + c[5, 5])
            )
            / 15.0
        )

    @property
    def k_reuss(self) -> float:
        s = self.compliance_voigt
        return float(
            1.0
            / (s[0, 0] + s[1, 1] + s[2, 2] + 2 * (s[0, 1] + s[0, 2] + s[1, 2]))
        )

    @property
    def g_reuss(self) -> float:
        s = self.compliance_voigt
        return float(
            15.0
            / (
                4 * (s[0, 0] + s[1, 1] + s[2, 2])
                - 4 * (s[0, 1] + s[0, 2] + s[1, 2])
                + 3 * (s[3, 3] + s[4, 4] + s[5, 5])
            )
        )

    @property
    def k_vrh(self) -> float:
        return 0.5 * (self.k_voigt + self.k_reuss)

    @property
    def g_vrh(self) -> float:
        return 0.5 * (self.g_voigt + self.g_reuss)

    @property
    def y_mod(self) -> float:
        """Young's modulus from the Hill averages: E = 9KG / (3K + G)."""
        k, g = self.k_vrh, self.g_vrh
        return float(9.0 * k * g / (3.0 * k + g))

    @property
    def homogeneous_poisson(self) -> float:
        """Isotropic Poisson ratio from the Hill averages."""
        k, g = self.k_vrh, self.g_vrh
        return float((3.0 * k - 2.0 * g) / (2.0 * (3.0 * k + g)))

    @property
    def universal_anisotropy(self) -> float:
        """Universal elastic anisotropy index A^U (Ranganathan & Ostoja-Starzewski)."""
        return float(
            5.0 * self.g_voigt / self.g_reuss + self.k_voigt / self.k_reuss - 6.0
        )

    @property
    def compliance_full(self) -> np.ndarray:
        """[3,3,3,3] compliance s_ijkl (Voigt factors 1/2/4 divided out)."""
        f = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 2.0])
        s_v = self.compliance_voigt / np.outer(f, f)
        return voigt_to_full(s_v)

    def directional_young_modulus(self, n: np.ndarray) -> float:
        """Young's modulus along unit direction n: E(n) = 1 / (s_ijkl n_i n_j n_k n_l).

        The directional stiffness pymatgen's ElasticTensor exposes via
        `directional_elastic_mod` on the compliance (reference users reach it
        through predict.py:217-218's pymatgen wrap). Equals `y_mod` for an
        isotropic tensor in every direction.
        """
        n = np.asarray(n, dtype=np.float64)
        n = n / np.linalg.norm(n)
        return float(1.0 / np.einsum("ijkl,i,j,k,l->", self.compliance_full, n, n, n, n))

    def linear_compressibility(self, n: np.ndarray) -> float:
        """Linear compressibility along n: beta(n) = s_ijkk n_i n_j
        (relative length change per unit hydrostatic pressure; equals
        1/(3K) in every direction for an isotropic tensor)."""
        n = np.asarray(n, dtype=np.float64)
        n = n / np.linalg.norm(n)
        return float(np.einsum("ijkk,i,j->", self.compliance_full, n, n))

    def to_pymatgen(self):
        """Wrap in a pymatgen ElasticTensor when pymatgen is importable
        (it is not in this environment; reference predict.py:217)."""
        try:
            from pymatgen.analysis.elasticity import ElasticTensor as PmgET
        except ImportError as e:  # pragma: no cover - env without pymatgen
            raise ImportError("pymatgen is not available") from e
        return PmgET(np.asarray(self))
