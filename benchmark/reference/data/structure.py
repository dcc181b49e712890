"""Minimal periodic crystal structure (no pymatgen/ASE dependency).

Parses the pymatgen `Structure.as_dict()` JSON layout the reference's input
contract uses (dataset/structure_scalar_tensor.py:241, datasets/*.json:
{"@module": "pymatgen.core.structure", "lattice": {"matrix": ...},
"sites": [{"species": [{"element": "Si", ...}], "abc": [...], ...}]}).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# fmt: off
ELEMENTS = [
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg", "Al",
    "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe",
    "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr",
    "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm",
    "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W",
    "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn",
    "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf",
    "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]
# fmt: on
SYMBOL_TO_Z: Dict[str, int] = {s: i + 1 for i, s in enumerate(ELEMENTS)}
Z_TO_SYMBOL: Dict[int, str] = {i + 1: s for i, s in enumerate(ELEMENTS)}


@dataclass
class Structure:
    """A periodic crystal: lattice rows, fractional coords, atomic numbers."""

    lattice: np.ndarray  # [3, 3], rows are lattice vectors (ASE convention)
    frac_coords: np.ndarray  # [N, 3]
    atomic_numbers: np.ndarray  # [N] int
    pbc: Tuple[bool, bool, bool] = (True, True, True)
    site_properties: Dict[str, list] = field(default_factory=dict)

    def __post_init__(self):
        self.lattice = np.asarray(self.lattice, dtype=np.float64).reshape(3, 3)
        self.frac_coords = np.asarray(self.frac_coords, dtype=np.float64).reshape(-1, 3)
        self.atomic_numbers = np.asarray(self.atomic_numbers, dtype=np.int64).reshape(-1)
        assert len(self.frac_coords) == len(self.atomic_numbers)

    def __len__(self) -> int:
        return len(self.atomic_numbers)

    @property
    def cart_coords(self) -> np.ndarray:
        return self.frac_coords @ self.lattice

    @property
    def species(self) -> List[str]:
        return [Z_TO_SYMBOL[int(z)] for z in self.atomic_numbers]

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.lattice)))

    @classmethod
    def from_dict(cls, d: dict) -> "Structure":
        """Parse a pymatgen Structure.as_dict() payload."""
        lattice = np.asarray(d["lattice"]["matrix"], dtype=np.float64)
        pbc = tuple(bool(b) for b in d["lattice"].get("pbc", (True, True, True)))
        frac = []
        zs = []
        props: Dict[str, list] = {}
        for site in d["sites"]:
            frac.append(site["abc"])
            sp = site["species"]
            # take the dominant-occupancy element (datasets here are ordered)
            el = max(sp, key=lambda e: e.get("occu", 1.0))["element"]
            zs.append(SYMBOL_TO_Z[el])
            for k, v in (site.get("properties") or {}).items():
                props.setdefault(k, []).append(v)
        return cls(lattice, np.asarray(frac), np.asarray(zs), pbc, props)

    def to_dict(self) -> dict:
        return {
            "@module": "pymatgen.core.structure",
            "@class": "Structure",
            "lattice": {"matrix": self.lattice.tolist(), "pbc": list(self.pbc)},
            "sites": [
                {
                    "species": [{"element": Z_TO_SYMBOL[int(z)], "occu": 1}],
                    "abc": list(map(float, abc)),
                }
                for z, abc in zip(self.atomic_numbers, self.frac_coords)
            ],
        }

    def rotate(self, r: np.ndarray) -> "Structure":
        """Rotate the lattice (and hence all cartesian coords) by 3x3 `r`."""
        return Structure(
            lattice=self.lattice @ np.asarray(r).T,
            frac_coords=self.frac_coords.copy(),
            atomic_numbers=self.atomic_numbers.copy(),
            pbc=self.pbc,
            site_properties=dict(self.site_properties),
        )
