"""Species and edge-length embeddings.

Counterpart of `matten_tpu/nn/embedding.py`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.nn.common import merge_irreps
from matten_tpu_torch.nn.edge_geometry import with_edge_vectors
from matten_tpu_torch.nn.radial import bessel_basis


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
    one-hot through the node mask."""

    def __init__(
        self,
        irreps_in: Mapping,
        allowed_species: Sequence[int],
        embedding_dim: int,
        generator: torch.Generator,
    ):
        super().__init__()
        self.allowed_species = tuple(int(z) for z in allowed_species)
        self.num_species = len(self.allowed_species)
        self.irreps_in = dict(irreps_in)
        self.irreps_out = merge_irreps(
            self.irreps_in,
            {
                K.NODE_ATTRS: Irreps(f"{self.num_species}x0e"),
                K.NODE_FEATURES: Irreps(f"{embedding_dim}x0e"),
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
        if K.NODE_MASK in data:
            attrs = attrs * data[K.NODE_MASK][:, None].to(dtype)
        data[K.NODE_ATTRS] = attrs
        data[K.NODE_FEATURES] = self.linear(attrs)
        return data


class EdgeLengthEmbedding(torch.nn.Module):
    """Edge length -> bessel radial basis [E, num_basis], scaled by
    sqrt(num_basis); zero-length padding edges get all-zero embeddings."""

    def __init__(
        self, irreps_in: Mapping, num_basis: int = 8, start: float = 0.0, end: float = 5.0
    ):
        super().__init__()
        self.num_basis, self.start, self.end = int(num_basis), float(start), float(end)
        self.irreps_in = dict(irreps_in)
        self.irreps_out = merge_irreps(
            self.irreps_in, {K.EDGE_EMBEDDING: Irreps(f"{self.num_basis}x0e")}
        )

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        data = dict(data)
        with_edge_vectors(data)
        emb = bessel_basis(data[K.EDGE_LENGTH], self.num_basis, self.start, self.end)
        emb = emb * float(np.sqrt(self.num_basis))
        if K.EDGE_MASK in data:
            emb = emb * data[K.EDGE_MASK][:, None].to(emb.dtype)
        data[K.EDGE_EMBEDDING] = emb
        return data
