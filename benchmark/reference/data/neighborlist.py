"""Periodic radius graph of the plain reference, in numpy: directed edges
(i, j, S) with r_ij = pos[j] - pos[i] + S @ cell and |r_ij| < r_cut,
edge_index[0] = i, cross-image self edges kept, true self edges dropped,
num_neigh[i] the out-degree of node i. A frozen copy of the port's numpy
path, without its native library.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

__all__ = ["periodic_radius_graph", "NeighborListError"]


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


def periodic_radius_graph(pos: np.ndarray, cell: np.ndarray, r_cut: float, pbc=(True, True, True),
                          self_interaction: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if isinstance(pbc, bool):
        pbc = (pbc,) * 3
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
