"""O(3) ops on torch tensors: tensor-product plans, spherical harmonics,
segment reductions and the Cartesian change of basis (counterparts of
`matten_tpu/ops/`)."""

from matten_tpu_torch.ops.irreps import Irrep, Irreps
from matten_tpu_torch.ops.wigner import wigner_3j, generators, rotation_matrix, irrep_rotation

__all__ = [
    "Irrep",
    "Irreps",
    "wigner_3j",
    "generators",
    "rotation_matrix",
    "irrep_rotation",
]
