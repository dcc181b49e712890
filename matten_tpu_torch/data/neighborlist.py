"""Periodic radius-graph construction (host-side, numpy).

Replaces ASE's `primitive_neighbor_list` (reference N9; called at
data/data.py:365 with self_interaction=True followed by stripping of
non-periodic self edges, data/data.py:380-393). Semantics preserved:

  * directed edges (i, j, S) with r_ij = pos[j] - pos[i] + S @ cell and
    |r_ij| < r_cut,
  * edge_index[0] = i (source / convolution center), edge_index[1] = j,
  * cross-image self edges (i == j, S != 0) kept; true self edges dropped,
  * num_neigh[i] = out-degree of node i.

Two backends with identical semantics:
  * a C++ kernel (csrc/neighborlist.cpp) compiled on first use and called
    via ctypes — the default, replacing ASE's C core;
  * a vectorized numpy fallback (image enumeration bounded by the cell's
    plane spacings).
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import logging
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["periodic_radius_graph", "NeighborListError"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _native_path() -> Path:
    """Build location of the library: keyed by the source and the host
    architecture, and compiled without -march=native, so a library built on
    one machine is never loaded on another kind."""
    src = _CSRC / "neighborlist.cpp"
    h = hashlib.sha256(src.read_bytes() + platform.machine().encode()).hexdigest()[:16]
    return _BUILD_ROOT / f"neighborlist-{h}" / "_neighborlist.so"


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the C++ neighbor-list kernel."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    src = _CSRC / "neighborlist.cpp"
    try:
        so = _native_path()
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", str(src), "-o", tmp],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
        fn = lib.periodic_neighbors
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # pos
            ctypes.c_int64,                   # n
            ctypes.POINTER(ctypes.c_double),  # cell
            ctypes.c_double,                  # r_cut
            ctypes.POINTER(ctypes.c_uint8),   # pbc
            ctypes.c_int,                     # self_interaction
            ctypes.c_int64,                   # max_edges
            ctypes.POINTER(ctypes.c_int64),   # out_i
            ctypes.POINTER(ctypes.c_int64),   # out_j
            ctypes.POINTER(ctypes.c_double),  # out_shift
            ctypes.POINTER(ctypes.c_double),  # out_num_neigh
        ]
        _LIB = lib
    except Exception as e:  # noqa: BLE001 — fall back to numpy
        logger.warning("native neighborlist unavailable (%s); using numpy", e)
        _LIB_FAILED = True
    return _LIB


class NeighborListError(ValueError):
    pass


def _image_ranges(cell: np.ndarray, r_cut: float, pbc) -> Tuple[int, int, int]:
    """Max image count per axis: ceil(r_cut / plane spacing)."""
    # plane spacing along axis i: volume / area of the face spanned by others
    vol = abs(np.linalg.det(cell))
    if vol < 1e-12:
        raise NeighborListError("singular cell")
    ns = []
    for i in range(3):
        if not pbc[i]:
            ns.append(0)
            continue
        j, k = (i + 1) % 3, (i + 2) % 3
        face = np.linalg.norm(np.cross(cell[j], cell[k]))
        spacing = vol / face
        ns.append(int(np.ceil(r_cut / spacing)))
    return tuple(ns)


def periodic_radius_graph(
    pos: np.ndarray,
    cell: np.ndarray,
    r_cut: float,
    pbc=(True, True, True),
    self_interaction: bool = False,
    backend: str = "auto",  # "auto" | "native" | "numpy"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the periodic radius graph (see module docstring)."""
    if isinstance(pbc, bool):
        pbc = (pbc,) * 3
    if backend != "numpy" and _load_native() is not None:
        out = _periodic_radius_graph_native(
            pos, cell, r_cut, pbc, self_interaction
        )
        if out is not None:
            return out
    elif backend == "native":
        raise NeighborListError("native backend requested but unavailable")
    return _periodic_radius_graph_numpy(pos, cell, r_cut, pbc, self_interaction)


def _sort_edges(i_idx, j_idx, edge_shifts, n):
    order = np.lexsort(
        (edge_shifts[:, 2], edge_shifts[:, 1], edge_shifts[:, 0], j_idx, i_idx)
    )
    i_idx, j_idx, edge_shifts = i_idx[order], j_idx[order], edge_shifts[order]
    if len(i_idx) == 0:
        raise NeighborListError("no edges remain in this system (increase r_cut?)")
    edge_index = np.stack([i_idx, j_idx]).astype(np.int64)
    num_neigh = np.bincount(i_idx, minlength=n).astype(np.float64)
    return edge_index, edge_shifts, num_neigh


def _periodic_radius_graph_native(pos, cell, r_cut, pbc, self_interaction):
    lib = _load_native()
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    pbc_arr = np.asarray(pbc, dtype=np.uint8)
    n = len(pos)
    max_edges = max(64 * n, 1024)
    for _ in range(4):
        out_i = np.empty(max_edges, dtype=np.int64)
        out_j = np.empty(max_edges, dtype=np.int64)
        out_shift = np.empty((max_edges, 3), dtype=np.float64)
        out_nn = np.empty(n, dtype=np.float64)
        count = lib.periodic_neighbors(
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n,
            cell.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(r_cut),
            pbc_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(self_interaction),
            max_edges,
            out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_shift.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_nn.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if count < 0:
            raise NeighborListError("singular cell")
        if count <= max_edges:
            return _sort_edges(out_i[:count], out_j[:count], out_shift[:count], n)
        max_edges = int(count)
    return None  # give up; numpy fallback


def _periodic_radius_graph_numpy(
    pos: np.ndarray,
    cell: np.ndarray,
    r_cut: float,
    pbc=(True, True, True),
    self_interaction: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the periodic radius graph (vectorized numpy).

    Args:
        pos: [N, 3] cartesian positions.
        cell: [3, 3] lattice vectors as rows.
        r_cut: cutoff radius.
        pbc: periodicity per axis.
        self_interaction: keep same-image self edges (default False, as the
            reference uses; cross-image self edges are always kept).

    Returns:
        edge_index [2, E] int64, edge_cell_shift [E, 3] float64, num_neigh [N].
    """
    pos = np.asarray(pos, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64)
    n = len(pos)
    if isinstance(pbc, bool):
        pbc = (pbc,) * 3
    nx, ny, nz = _image_ranges(cell, r_cut, pbc)

    shifts = np.array(
        list(
            itertools.product(
                range(-nx, nx + 1), range(-ny, ny + 1), range(-nz, nz + 1)
            )
        ),
        dtype=np.float64,
    )  # [S, 3]
    disp = shifts @ cell  # [S, 3]

    # all-pairs per shift: r = pos[j] + disp - pos[i]
    # [S, N_i, N_j, 3]
    diff = pos[None, None, :, :] + disp[:, None, None, :] - pos[None, :, None, :]
    dist2 = np.einsum("sijk,sijk->sij", diff, diff)
    within = dist2 < r_cut * r_cut

    # remove true self edges (i == j in the home image)
    zero_shift = np.all(shifts == 0, axis=1)
    if not self_interaction:
        eye = np.eye(n, dtype=bool)
        within[zero_shift] &= ~eye
    else:
        # still drop the zero-distance i==i@home edge? reference keeps it
        # only when self_interaction=True; zero distance is fine there.
        pass

    s_idx, i_idx, j_idx = np.nonzero(within)
    edge_shifts = shifts[s_idx]
    return _sort_edges(i_idx, j_idx, edge_shifts, n)
