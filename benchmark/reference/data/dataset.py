"""Tensor datasets: JSON tables of structures + tensorial targets -> graphs.

Counterpart of `matten_tpu/data/dataset.py` (`TensorDatasetConfig`,
`load_tensor_dataset`, `DatasetStatistics`), without pandas: the file is a
table written by `pandas.DataFrame.to_json`, either in its default layout
(orient "columns", `{column: {row: value}}`) or as a list of records
(orient "records"), with a `structure` column of pymatgen Structure dicts
and target columns — a rank-k Cartesian tensor per crystal (e.g.
`elastic_tensor_full`, 3x3x3x3) or per selected atom (e.g. `nmr_tensor`,
[num_selected, 3, 3] + an `atom_selector` boolean column), plus optional
scalar target columns (optionally log-transformed), feature columns and a
column whose values pick each crystal's target weight. The tensor target is
read as irreps or as the flat Cartesian components, times a scale.
`read_table` gives the rows in pandas' row order and reads every number as
`pandas.read_json` does by default, so a file gives the same arrays here as
in the JAX package.

Per-atom targets are scattered into dense per-node arrays with the selector
beside them; rows whose conversion fails are recorded and skipped.
"""

from __future__ import annotations

import json
import logging
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.data.graph import CrystalGraph
from benchmark.reference.data.structure import Structure
from benchmark.reference.data.transform import MeanNormNormalize, ScalarNormalize
from benchmark.reference.ops.cartesian import cartesian_tensor_map

logger = logging.getLogger(__name__)

__all__ = ["TensorDatasetConfig", "load_tensor_dataset", "DatasetStatistics", "read_table"]


@dataclass
class TensorDatasetConfig:
    r_cut: float = 5.0
    tensor_target_name: Optional[str] = "elastic_tensor_full"
    tensor_target_format: str = "irreps"  # "irreps" | "cartesian" (flat components)
    tensor_target_formula: str = "ijkl=jikl=klij"
    tensor_target_scale: float = 1.0
    atom_selector: Optional[str] = None  # column name of per-atom selector
    scalar_target_names: Tuple[str, ...] = ()
    log_scalar_targets: Tuple[bool, ...] = ()
    # {column: {value: weight}}: each crystal's loss weight, picked by its
    # value in the column, into x["target_weight"]
    tensor_target_weight: Optional[Dict[str, Dict[Any, float]]] = None
    # precomputed feature columns: each atom-feature column holds an
    # [N_atom, f] (or [N_atom]) array per row, each global column one
    # scalar/vector per crystal; concatenated feature-wise into
    # x["atom_feats"] / x["global_feats"]
    atom_feats_columns: Tuple[str, ...] = ()
    global_feats_columns: Tuple[str, ...] = ()

    @property
    def per_atom(self) -> bool:
        return self.atom_selector is not None

    @property
    def target_irreps(self):
        return cartesian_tensor_map(self.tensor_target_formula).irreps


# 10^-k for k fractional digits, as pandas' JSON decoder holds them
_POW10 = tuple(float(f"1e-{k}") for k in range(16))
_MAX_DECIMALS = 15


def _pandas_float(s: str) -> float:
    """A JSON number with a fraction or exponent, converted as pandas'
    default decoder (`read_json(precise_float=False)`) converts it: the
    integer digits as an integer, at most 15 fractional digits accumulated
    in a double and scaled by 10^-count, then times 10^exponent. This is
    not the correctly rounded value `float(s)` gives: the two differ in the
    last bit for about a third of 10-digit fractions."""
    neg = s[0] == "-"
    i, n = int(neg), len(s)
    whole = 0
    while i < n and s[i].isdigit():
        whole = whole * 10 + ord(s[i]) - 48
        i += 1
    frac, count = 0.0, 0
    if i < n and s[i] == ".":
        i += 1
        while i < n and s[i].isdigit():
            if count < _MAX_DECIMALS:
                frac = frac * 10.0 + (ord(s[i]) - 48)
                count += 1
            i += 1
    value = (float(whole) + frac * _POW10[count]) * (-1.0 if neg else 1.0)
    if i < n and s[i] in "eE":
        i += 1
        sign = 1.0
        if s[i] in "+-":
            sign = -1.0 if s[i] == "-" else 1.0
            i += 1
        exp = 0.0
        while i < n:
            exp = exp * 10.0 + (ord(s[i]) - 48)
            i += 1
        value = value * 10.0 ** (exp * sign)
    return value


def read_table(filename) -> List[Dict[str, Any]]:
    """The rows of a `DataFrame.to_json` file as dicts, in pandas' row order.

    Orient "columns" (pandas' default) holds `{column: {row key: value}}`:
    the rows come in the order their keys first appear, the columns in file
    order, and a row missing from a column gets NaN there. Orient "records"
    holds a list of row dicts. Nested values (structure dicts, per-atom
    lists) come through as JSON dicts and lists."""
    with open(filename) as f:
        table = json.load(f, parse_float=_pandas_float)
    if isinstance(table, list):
        columns = list(dict.fromkeys(c for row in table for c in row))
        return [{c: row.get(c, float("nan")) for c in columns} for row in table]
    if not isinstance(table, dict) or not all(isinstance(v, dict) for v in table.values()):
        raise ValueError(f"{filename}: not a DataFrame.to_json table (orient 'columns' or 'records')")
    keys = list(dict.fromkeys(k for col in table.values() for k in col))
    return [{c: col.get(k, float("nan")) for c, col in table.items()} for k in keys]


def _convert_target(cfg: TensorDatasetConfig, cmap, t) -> np.ndarray:
    """Cartesian tensor(s) -> irreps vectors (the same numpy float64
    product as the JAX package's `from_cartesian`), or flat Cartesian
    components, one row per tensor."""
    t = np.asarray(t, dtype=np.float64)
    flat = t.reshape(t.shape[: t.ndim - cmap.rank] + (3**cmap.rank,))
    if cfg.tensor_target_format == "irreps":
        return np.atleast_2d(flat @ cmap.basis.T)
    if cfg.tensor_target_format == "cartesian":
        return flat.reshape(-1, 3**cmap.rank)
    raise ValueError(f"unsupported tensor_target_format {cfg.tensor_target_format!r}")


def load_tensor_dataset(
    filename,
    cfg: TensorDatasetConfig,
    structures: Optional[Sequence[Structure]] = None,
    dummy_targets: bool = False,
) -> Tuple[List[CrystalGraph], List[int]]:
    """Read + convert a dataset file (or an explicit structure list).

    With `dummy_targets` (what `predict` uses) every target is zeros and a
    per-atom selector selects every atom. Returns (graphs,
    failed_row_indices)."""
    if structures is not None:
        rows: List[Dict[str, Any]] = [{"structure": s} for s in structures]
    else:
        rows = read_table(filename)
        if not rows or "structure" not in rows[0]:
            raise ValueError(
                f"Unsupported input data from `{filename}`: needs a `structure` "
                f"column of pymatgen Structure dicts"
            )
        for r in rows:
            r["structure"] = Structure.from_dict(r["structure"])

    graphs: List[CrystalGraph] = []
    failed: List[int] = []
    cmap = cartesian_tensor_map(cfg.tensor_target_formula)
    tdim = cmap.irreps.dim if cfg.tensor_target_format == "irreps" else 3**cmap.rank
    log_scalars = cfg.log_scalar_targets or (False,) * len(cfg.scalar_target_names)
    for i, row in enumerate(rows):
        try:
            struct: Structure = row["structure"]
            n = len(struct)
            y: Dict[str, np.ndarray] = {}
            x: Dict[str, np.ndarray] = {}
            if cfg.tensor_target_name:
                if dummy_targets:
                    raw = np.zeros((n, tdim)) if cfg.per_atom else np.zeros((1, tdim))
                else:
                    raw = _convert_target(cfg, cmap, row[cfg.tensor_target_name]) * cfg.tensor_target_scale
                if cfg.per_atom:
                    sel = (
                        np.asarray(row[cfg.atom_selector], dtype=bool)
                        if not dummy_targets
                        else np.ones(n, dtype=bool)
                    )
                    if len(sel) != n:
                        raise ValueError("atom_selector length != num atoms")
                    dense = np.zeros((n, tdim))
                    if not dummy_targets:
                        if raw.shape[0] != int(sel.sum()):
                            raise ValueError(f"target rows {raw.shape[0]} != selected atoms {sel.sum()}")
                        dense[sel] = raw
                    y[cfg.tensor_target_name] = dense
                    y["atom_selector"] = sel
                else:
                    y[cfg.tensor_target_name] = raw.reshape(1, tdim)
            for name, do_log in zip(cfg.scalar_target_names, log_scalars):
                v = np.atleast_2d(np.asarray(row[name], dtype=np.float64))
                y[name] = np.log(v) if do_log else v
            if cfg.tensor_target_weight and not dummy_targets:
                ((col, table),) = cfg.tensor_target_weight.items()
                x["target_weight"] = np.asarray([[table[row[col]]]])
            if cfg.atom_feats_columns:
                af = np.concatenate(
                    [np.asarray(row[c], dtype=np.float64).reshape(n, -1) for c in cfg.atom_feats_columns],
                    axis=-1,
                )
                if not np.isfinite(af).all():
                    raise ValueError("NaN/Inf in atom feats")
                x["atom_feats"] = af
            if cfg.global_feats_columns:
                gf = np.concatenate(
                    [np.asarray(row[c], dtype=np.float64).reshape(1, -1) for c in cfg.global_feats_columns],
                    axis=-1,
                )
                if not np.isfinite(gf).all():
                    raise ValueError("NaN/Inf in global feats")
                x["global_feats"] = gf
            graphs.append(CrystalGraph.from_structure(struct, r_cut=cfg.r_cut, x=x, y=y))
        except Exception as e:  # noqa: BLE001 — failure-tolerant conversion
            warnings.warn(f"Failed converting structure {i}; skipping: {e}")
            failed.append(i)
    if not graphs:
        raise RuntimeError("Cannot successfully convert any structures.")
    return graphs, failed


@dataclass
class DatasetStatistics:
    """Training-set statistics that travel with the checkpoint: the target
    normalizers and the dataset -> model hand-off (allowed species, average
    number of neighbours)."""

    allowed_species: Tuple[int, ...] = ()
    average_num_neighbors: float = 1.0
    target_normalizer: Optional[MeanNormNormalize] = None
    # per scalar target: its standardizer
    scalar_normalizers: Dict[str, ScalarNormalize] = field(default_factory=dict)
    # per-column standardizers of precomputed atom/global features
    feature_normalizers: Dict[str, ScalarNormalize] = field(default_factory=dict)

    @classmethod
    def compute(
        cls,
        graphs: Sequence[CrystalGraph],
        cfg: TensorDatasetConfig,
        normalize_tensor_target: bool = False,
    ) -> "DatasetStatistics":
        """The statistics of a training set. The target normalizer (of
        irreps targets only) and the scalar normalizers are computed whether
        or not the data module applies them (the metrics read them either
        way)."""
        zs = sorted({int(z) for g in graphs for z in g.atomic_numbers})
        avg_nn = float(np.mean(np.concatenate([g.num_neigh for g in graphs])))
        tnorm = None
        if cfg.tensor_target_name and cfg.tensor_target_format == "irreps":
            if cfg.per_atom:
                data = np.concatenate(
                    [g.y[cfg.tensor_target_name][g.y["atom_selector"]] for g in graphs]
                )
            else:
                data = np.concatenate([g.y[cfg.tensor_target_name] for g in graphs])
            tnorm = MeanNormNormalize(irreps=cfg.target_irreps)
            tnorm.compute_statistics(data)
        scalar_norms: Dict[str, ScalarNormalize] = {}
        for name in cfg.scalar_target_names:
            vals = np.concatenate([np.atleast_2d(g.y[name]) for g in graphs])
            sn = ScalarNormalize(num_features=vals.shape[-1])
            sn.compute_statistics(vals)
            scalar_norms[name] = sn
        feat_norms: Dict[str, ScalarNormalize] = {}
        for name in ("atom_feats", "global_feats"):
            if graphs and name in graphs[0].x:
                vals = np.concatenate([np.atleast_2d(g.x[name]) for g in graphs])
                fn = ScalarNormalize(num_features=vals.shape[-1])
                fn.compute_statistics(vals)
                feat_norms[name] = fn
        return cls(
            allowed_species=tuple(zs),
            average_num_neighbors=avg_nn,
            target_normalizer=tnorm,
            scalar_normalizers=scalar_norms,
            feature_normalizers=feat_norms,
        )

    # ---- (de)serialization -------------------------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        out = {
            "allowed_species": np.asarray(self.allowed_species, dtype=np.int64),
            "average_num_neighbors": np.asarray(self.average_num_neighbors),
        }
        if self.target_normalizer is not None and self.target_normalizer.initialized:
            out["target_mean"] = self.target_normalizer.mean
            out["target_norm"] = self.target_normalizer.norm
        for k, sn in self.scalar_normalizers.items():
            out[f"scalar_{k}_mean"] = sn.mean
            out[f"scalar_{k}_std"] = sn.std
        for k, fn in self.feature_normalizers.items():
            out[f"feat_{k}_mean"] = fn.mean
            out[f"feat_{k}_std"] = fn.std
        return out

    @classmethod
    def from_arrays(
        cls, arrays: Dict[str, np.ndarray], cfg: TensorDatasetConfig
    ) -> "DatasetStatistics":
        tnorm = None
        if "target_mean" in arrays:
            tnorm = MeanNormNormalize(
                irreps=cfg.target_irreps,
                mean=np.asarray(arrays["target_mean"]),
                norm=np.asarray(arrays["target_norm"]),
            )
        norms: Dict[str, Dict[str, ScalarNormalize]] = {"scalar_": {}, "feat_": {}}
        for k in arrays:
            for prefix, found in norms.items():
                if k.startswith(prefix) and k.endswith("_mean"):
                    name = k[len(prefix) : -len("_mean")]
                    mean = np.asarray(arrays[k])
                    std = np.asarray(arrays[f"{prefix}{name}_std"])
                    found[name] = ScalarNormalize(num_features=mean.shape[-1], mean=mean, std=std)
        return cls(
            allowed_species=tuple(int(z) for z in np.asarray(arrays["allowed_species"])),
            average_num_neighbors=float(arrays["average_num_neighbors"]),
            target_normalizer=tnorm,
            scalar_normalizers=norms["scalar_"],
            feature_normalizers=norms["feat_"],
        )

    def save(self, path) -> None:
        np.savez(path, **self.to_arrays())

    @classmethod
    def load(cls, path, cfg: TensorDatasetConfig) -> "DatasetStatistics":
        with np.load(path) as f:
            return cls.from_arrays(dict(f), cfg)
