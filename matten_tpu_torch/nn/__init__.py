"""Dict-passing torch modules of the TFN model (counterparts of
`matten_tpu/nn/`)."""

from matten_tpu_torch.nn.common import irreps_dict
from matten_tpu_torch.nn.embedding import SpeciesEmbedding, EdgeLengthEmbedding
from matten_tpu_torch.nn.edge_geometry import SphericalHarmonicEdgeAttrs, with_edge_vectors
from matten_tpu_torch.nn.gate import Gate, NormActivation, ActivationInfo
from matten_tpu_torch.nn.norm import IrrepsBatchNorm, IrrepsInstanceNorm
from matten_tpu_torch.nn.conv import PointConv, PointConvWithActivation
from matten_tpu_torch.nn.nodewise import NodewiseLinear, NodewiseReduce, NodewiseSelect
from matten_tpu_torch.nn.sequential import Sequential

__all__ = [
    "irreps_dict",
    "SpeciesEmbedding",
    "EdgeLengthEmbedding",
    "SphericalHarmonicEdgeAttrs",
    "with_edge_vectors",
    "Gate",
    "NormActivation",
    "ActivationInfo",
    "IrrepsBatchNorm",
    "IrrepsInstanceNorm",
    "PointConv",
    "PointConvWithActivation",
    "NodewiseLinear",
    "NodewiseReduce",
    "NodewiseSelect",
    "Sequential",
]
