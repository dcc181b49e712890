"""The one generator of the benchmark's traffic: a mix file's parameters
and a configuration's crystals -> the dataset files that a cell trains on.

A mix (`traffic/<name>.json`) is a closed loop of `Trainer.fit` epochs: it
gives the atoms per crystal, the cell sides, and the epochs that warm-up
and the traced run take; the configuration gives the train and validation
set sizes (`dataset_crystals`). The crystals are synthetic, those of
`chip_smoke.py::draw_structures` (a cubic cell of side 3.5-5.0 Angstrom
perturbed by N(0, 0.1), uniform fractional coordinates with no least
distance, species drawn uniformly from the configuration's palette): no
published statistic of a dataset backs their sizes, densities or species,
with a symmetric Cartesian target as `chip_smoke.py::fit_rows` draws it:
per crystal (the elasticity tensor, N(0, 1) * scale) or per atom of the
selected species (N(0, 1) * scale + offset * identity), the first atom of
each crystal of that species.

Every seed trains on the same crystal geometries (atoms, cell and
positions, and so the same neighbour lists and pad ladders), drawn once
from a fixed generator and written in one order, with its own species and
targets, and the loader shuffles them in its own order: the seed changes
what is computed, not how much.
The files are tables in pandas' "records" layout with pymatgen Structure
dicts, which the port's data module and the reference's copy both read.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from benchmark.reference.data.structure import ELEMENTS

__all__ = ["set_sizes", "draw_rows", "write_split"]

# the fixed generator of the geometries every seed shares
SIZES_SEED = 0x5EED


def set_sizes(mix: Dict[str, Any], config: Dict[str, Any]) -> Dict[str, int]:
    """Crystals in each split, as the configuration's deployment holds them."""
    return {split: int(config["dataset_crystals"][split]) for split in ("train", "val")}


def _symmetric(t: np.ndarray, formula: str) -> np.ndarray:
    """The part of a Cartesian tensor with the symmetries of `formula`
    ("ij=ji" or "ijkl=jikl=klij")."""
    if formula == "ij=ji":
        return (t + t.T) / 2
    if formula == "ijkl=jikl=klij":
        t = (t + t.transpose(1, 0, 2, 3)) / 2
        t = (t + t.transpose(0, 1, 3, 2)) / 2
        return (t + t.transpose(2, 3, 0, 1)) / 2
    raise ValueError(f"no target draw for formula {formula!r}")


def _structure_dict(lattice: np.ndarray, frac: np.ndarray, z: np.ndarray) -> dict:
    return {
        "@module": "pymatgen.core.structure",
        "@class": "Structure",
        "lattice": {"matrix": lattice.tolist(), "pbc": [True, True, True]},
        "sites": [{"species": [{"element": ELEMENTS[int(k) - 1], "occu": 1}], "abc": [float(v) for v in f]}
                  for k, f in zip(z, frac)],
    }


def draw_rows(mix: Dict[str, Any], config: Dict[str, Any], seed: int) -> Dict[str, List[dict]]:
    """{"train": rows, "val": rows} of one seed (module docstring)."""
    crystals = config["crystals"]
    data = config["data"]
    species = np.asarray(crystals["species"], dtype=np.int64)
    target = data["tensor_target_name"]
    formula = data["tensor_target_formula"]
    rank = len(formula.split("=")[0])
    selected = crystals.get("selected_species")
    lo, hi = mix["atoms"]
    sides = mix["cell_side"]
    fixed = np.random.default_rng(SIZES_SEED)
    rng = np.random.default_rng(seed)
    out = {}
    for split, n in set_sizes(mix, config).items():
        atoms = fixed.integers(lo, hi + 1, size=n)
        cells = [np.eye(3) * (sides[0] + fixed.uniform(0, sides[1] - sides[0])) + fixed.normal(size=(3, 3)) * 0.1
                 for _ in range(n)]
        coords = [fixed.uniform(0, 1, size=(int(k), 3)) for k in atoms]
        rows = []
        for lattice, frac in zip(cells, coords):
            z = rng.choice(species, size=len(frac))
            row = {}
            if selected is None:
                row[target] = (_symmetric(rng.normal(size=(3,) * rank), formula) * crystals["target_scale"]).tolist()
            else:
                z[0] = selected
                sel = z == selected
                row["atom_selector"] = sel.tolist()
                row[target] = [(_symmetric(rng.normal(size=(3,) * rank), formula) * crystals["target_scale"]
                                + np.eye(3) * crystals["target_offset"]).tolist() for _ in range(int(sel.sum()))]
            row["structure"] = _structure_dict(lattice, frac, z)
            rows.append(row)
        out[split] = rows
    return out


def write_split(rows: List[dict], path: Path) -> Path:
    with open(path, "w") as f:
        json.dump(rows, f)
    return path
