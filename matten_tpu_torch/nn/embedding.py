"""Species and edge-length embeddings, and node attributes from edge
attributes.

Counterpart of `matten_tpu/nn/embedding.py`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.nn.common import merge_irreps
from matten_tpu_torch.nn.edge_geometry import gather_positions, with_edge_vectors
from matten_tpu_torch.nn.radial import soft_one_hot_linspace
from matten_tpu_torch.ops.scatter import scatter_mean, scatter_sum


def atomic_number_map(allowed_species: Sequence[int]) -> np.ndarray:
    """Lookup table mapping Z -> species index (-1 for unsupported), over
    0..max_Z + 1."""
    allowed = sorted(int(z) for z in allowed_species)
    table = np.full(max(allowed) + 2, -1, dtype=np.int32)
    for i, z in enumerate(allowed):
        table[z] = i
    return table


class SpeciesEmbedding(torch.nn.Module):
    """Atomic number -> one-hot node_attrs [N, S] and node_features =
    Linear(node_attrs) [N, D] (with bias). Padded nodes get an all-zero
    one-hot through the node mask. With `use_atom_feats` the batch's
    per-node `atom_feats` [N, A] are concatenated to the features, with
    `use_global_feats` its per-crystal `global_feats` [G, F], gathered per
    node by `batch` and zeroed on padded nodes: features [N, D + A + F]."""

    MARK = "embed"  # its device time's name (`nn.sequential.Sequential`)

    def __init__(
        self,
        irreps_in: Mapping,
        allowed_species: Sequence[int],
        embedding_dim: int,
        generator: torch.Generator,
        use_atom_feats: bool = False,
        atom_feats_dim: int = 0,
        use_global_feats: bool = False,
        global_feats_dim: int = 0,
    ):
        super().__init__()
        self.allowed_species = tuple(int(z) for z in allowed_species)
        self.num_species = len(self.allowed_species)
        self.use_atom_feats, self.use_global_feats = bool(use_atom_feats), bool(use_global_feats)
        feats_dim = (
            embedding_dim
            + (atom_feats_dim if self.use_atom_feats else 0)
            + (global_feats_dim if self.use_global_feats else 0)
        )
        self.irreps_in = dict(irreps_in)
        self.irreps_out = merge_irreps(
            self.irreps_in,
            {
                K.NODE_ATTRS: Irreps(f"{self.num_species}x0e"),
                K.NODE_FEATURES: Irreps(f"{feats_dim}x0e"),
            },
        )
        self.linear = torch.nn.Linear(self.num_species, embedding_dim)
        with torch.no_grad():
            # lecun-normal weight and zero bias, as flax Dense initializes
            self.linear.weight.copy_(
                torch.randn(embedding_dim, self.num_species, generator=generator)
                / np.sqrt(self.num_species)
            )
            self.linear.bias.zero_()
        self.register_buffer(
            "species_table",
            torch.as_tensor(atomic_number_map(self.allowed_species), dtype=torch.long),
            persistent=False,
        )

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        if K.SPECIES_INDEX in data:
            idx = data[K.SPECIES_INDEX].long()
        else:
            z = data[K.ATOMIC_NUMBERS].long().clamp(0, self.species_table.shape[0] - 1)
            idx = self.species_table[z]
            data[K.SPECIES_INDEX] = idx
        idx = idx.clamp(0, self.num_species - 1)
        dtype = data[K.POSITIONS].dtype
        attrs = torch.nn.functional.one_hot(idx, self.num_species).to(dtype)
        mask = data.get(K.NODE_MASK)
        if mask is not None:
            attrs = attrs * mask[:, None].to(dtype)
        feats = [self.linear(attrs)]
        if self.use_atom_feats:
            feats.append(data[K.ATOM_FEATS].to(dtype))
        if self.use_global_feats:
            per_node = data[K.GLOBAL_FEATS][data[K.BATCH].long()].to(dtype)
            if mask is not None:
                per_node = per_node * mask[:, None].to(dtype)
            feats.append(per_node)
        data[K.NODE_ATTRS] = attrs
        data[K.NODE_FEATURES] = torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]
        return data


class NodeAttrsFromEdgeAttrs(torch.nn.Module):
    """Node attributes as a segment reduction of edge attributes into the
    destination nodes: "mean" weighted by the edge mask, or (any other
    `reduce`) the sum of the masked rows."""

    def __init__(
        self,
        irreps_in: Mapping,
        field: str = K.EDGE_ATTRS,
        out_field: str = K.NODE_ATTRS,
        reduce: str = "mean",
    ):
        super().__init__()
        self.field, self.out_field, self.reduce = field, out_field, reduce
        self.irreps_in = dict(irreps_in)
        self.irreps_out = merge_irreps(self.irreps_in, {out_field: self.irreps_in[field]})

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        _, dst = data[K.EDGE_INDEX]
        num_nodes = data[K.POSITIONS].shape[0]
        x = data[self.field]
        if self.reduce == "mean":
            out = scatter_mean(x, dst, num_nodes, weights=data.get(K.EDGE_MASK))
        else:
            if K.EDGE_MASK in data:
                x = x * data[K.EDGE_MASK][:, None].to(x.dtype)
            out = scatter_sum(x, dst, num_nodes)
        data[self.out_field] = out
        return data


class EdgeLengthEmbedding(torch.nn.Module):
    """Edge length -> radial basis [E, num_basis] ("bessel" or "gaussian"),
    scaled by sqrt(num_basis) and zeroed on padding edges by the edge mask
    (the bessel window already zeroes their zero length; the gaussian has
    no window). `gather_axis`: as `SphericalHarmonicEdgeAttrs`'."""

    MARK = "embed"  # its device time's name (`nn.sequential.Sequential`)

    def __init__(
        self,
        irreps_in: Mapping,
        num_basis: int = 8,
        start: float = 0.0,
        end: float = 5.0,
        basis: str = "bessel",
        gather_axis: Optional[str] = None,
    ):
        super().__init__()
        self.gather_axis = gather_axis
        if basis not in ("bessel", "gaussian"):
            raise ValueError(f"unsupported basis {basis!r}")
        self.num_basis, self.start, self.end = int(num_basis), float(start), float(end)
        self.basis = basis
        self.irreps_in = dict(irreps_in)
        self.irreps_out = merge_irreps(
            self.irreps_in, {K.EDGE_EMBEDDING: Irreps(f"{self.num_basis}x0e")}
        )

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        gather_positions(data, self.gather_axis)
        with_edge_vectors(data)
        emb = soft_one_hot_linspace(data[K.EDGE_LENGTH], self.start, self.end, self.num_basis,
                                    self.basis)
        emb = emb * float(np.sqrt(self.num_basis))
        if K.EDGE_MASK in data:
            emb = emb * data[K.EDGE_MASK][:, None].to(emb.dtype)
        data[K.EDGE_EMBEDDING] = emb
        return data
