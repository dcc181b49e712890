"""TFN model assembly: hparams dict -> layer stack with irreps threaded.

Counterpart of `matten_tpu/models/tfn.py`, both model families:

  SpeciesEmbedding -> SphericalHarmonicEdgeAttrs -> EdgeLengthEmbedding
  -> num_layers x PointConvWithActivation -> PointConv
  -> NodewiseLinear head
  -> graph-level `ScalarTensorModel`: NodewiseReduce pooling, then an
     equivariant Linear head into the irreps of `output_formula`, and with
     `scalar_target_names` one 0e Linear head per scalar target beside it;
     per-atom `AtomicTensorModel`: the NodewiseLinear head maps straight
     into those irreps (one row per node, no pooling).

Parameters are drawn from a seeded `torch.Generator` on the CPU and the
model is then moved to `device`, the card unless the caller passes another.

At DEBUG log level (`utils.logging.set_logger("DEBUG")`) a
`utils.anomaly.DetectAnomaly` follows every layer of the backbone, as in
the JAX factory: a NaN or Inf raises after the layer that made it (one
host sync per layer). The backbone's `layers.{i}` then match the flax
`layers_{i}` of a DEBUG-built JAX model, so `convert.flax_to_state_dict`
carries its variables.

The hparams `graph_parallel_axis` ("graph") and `graph_parallel_mode`
("edge", "node" or "node_ring") build the graph-parallel model: the same
parameters, with the convs, and under the node modes the edge geometry, the
batch norm and the pooling, taking their part of a graph split over the
mesh's graph axis (`nn/conv.py`, `parallel/`). Such a model runs only on
a rank's block of a sharded batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch

from benchmark.reference.data import keys as K
from benchmark.reference.ops.irreps import Irreps
from benchmark.reference.nn.conv import PointConv, PointConvWithActivation
from benchmark.reference.nn.common import normal_parameter
from benchmark.reference.nn.edge_geometry import SphericalHarmonicEdgeAttrs
from benchmark.reference.nn.embedding import EdgeLengthEmbedding, SpeciesEmbedding
from benchmark.reference.nn.nodewise import NodewiseLinear, NodewiseReduce
from benchmark.reference.nn.sequential import Sequential
from benchmark.reference.ops.cartesian import cartesian_tensor_map
from benchmark.reference.ops.tensor_product import LinearPlan

OUT_FIELD = "model_output"


def _resolve_avg_num_neighbors(hparams, dataset_hparams) -> Optional[float]:
    v = hparams.get("average_num_neighbors", None)
    if isinstance(v, str) and v.lower() == "auto":
        return dataset_hparams["average_num_neighbors"]
    return v


def create_tfn_backbone(
    hparams: Dict[str, Any],
    dataset_hparams: Dict[str, Any],
    head_irreps: Irreps,
    pooling: Optional[str],
    generator: torch.Generator,
) -> Sequential:
    irreps = {K.POSITIONS: Irreps("1o")}
    layers = []

    graph_axis = hparams.get("graph_parallel_axis", None)
    graph_shard_mode = hparams.get("graph_parallel_mode", "edge")
    # the node modes split the nodes too: positions gathered, statistics
    # and pooled sums summed over the axis
    node_axis = graph_axis if graph_shard_mode in ("node", "node_ring") else None

    m = SpeciesEmbedding(
        irreps,
        allowed_species=dataset_hparams["allowed_species"],
        embedding_dim=hparams.get("species_embedding_dim", 16),
        generator=generator,
        use_atom_feats=hparams.get("use_atom_feats", False),
        atom_feats_dim=dataset_hparams.get("atom_feats_size") or 0,
        use_global_feats=hparams.get("use_global_feats", False),
        global_feats_dim=dataset_hparams.get("global_feats_size") or 0,
    )
    layers.append(m)
    m = SphericalHarmonicEdgeAttrs(
        m.irreps_out,
        Irreps(hparams["irreps_edge_sh"]),
        require_position_gradients=hparams.get("require_position_gradients", False),
        gather_axis=node_axis,
    )
    layers.append(m)
    m = EdgeLengthEmbedding(
        m.irreps_out,
        num_basis=hparams.get("num_radial_basis", 8),
        start=hparams.get("radial_basis_start", 0.0),
        end=hparams.get("radial_basis_end", 5.0),
        basis=hparams.get("radial_basis_type", "bessel"),
        gather_axis=node_axis,
    )
    layers.append(m)

    avg_num_neighbors = _resolve_avg_num_neighbors(hparams, dataset_hparams)
    conv_irreps = Irreps(hparams["conv_layer_irreps"])
    fc = dict(
        fc_num_hidden_layers=hparams.get("invariant_layers", 2),
        fc_hidden_size=hparams.get("invariant_neurons", 32),
        avg_num_neighbors=avg_num_neighbors,
        graph_axis=graph_axis,
        graph_shard_mode=graph_shard_mode,
    )
    convs = []
    for _ in range(hparams.get("num_layers", 3)):
        m = PointConvWithActivation(
            m.irreps_out,
            conv_irreps,
            generator,
            activation_type=hparams.get("nonlinearity_type", "gate"),
            normalization=hparams.get("normalization", None),
            **fc,
        )
        layers.append(m)
        convs.append(m.conv)
    m = PointConv(m.irreps_out, conv_irreps, generator, **fc)
    layers.append(m)
    convs.append(m)
    # the layers share one edge plan per forward: its K1 items serve every
    # layer's tier
    for conv in convs:
        conv.peer_plans = tuple(c.uvu_plan for c in convs)
    m = NodewiseLinear(m.irreps_out, head_irreps, generator, out_field=OUT_FIELD)
    layers.append(m)
    if pooling is not None:
        layers.append(
            NodewiseReduce(m.irreps_out, field=OUT_FIELD, out_field=OUT_FIELD, reduce=pooling,
                           axis=node_axis)
        )
    return Sequential(layers)


def _target_irreps(formula: str) -> Irreps:
    if formula == "scalar":
        return Irreps("0e")
    return cartesian_tensor_map(formula).irreps


class ScalarTensorModel(torch.nn.Module):
    """Graph-level scalar/tensor prediction: backbone + equivariant Linear
    head into the target irreps ([num_graphs, dim]), optional Cartesian
    readout. With `scalar_target_names`, one 0e Linear head `w_{name}` per
    scalar target reads the same pooled features and the model returns
    {tensor_target_name: tensor, name: [num_graphs, 1], ...}."""

    def __init__(
        self,
        backbone: Sequential,
        hidden_irreps: Irreps,
        generator: torch.Generator,
        output_formula: str = "ijkl=jikl=klij",
        output_format: str = "irreps",
        tensor_target_name: str = "elastic_tensor_full",
        scalar_target_names: Sequence[str] = (),
    ):
        super().__init__()
        self.backbone = backbone
        self.output_formula = output_formula
        self.output_format = output_format
        self.tensor_target_name = tensor_target_name
        self.scalar_target_names = tuple(scalar_target_names)
        self.plan = LinearPlan(Irreps(hidden_irreps), _target_irreps(output_formula))
        self.w_out = normal_parameter(self.plan.weight_numel, generator)
        self.scalar_plan = LinearPlan(Irreps(hidden_irreps), Irreps("0e"))
        for name in self.scalar_target_names:
            self.register_parameter(f"w_{name}", normal_parameter(self.scalar_plan.weight_numel, generator))

    def forward(self, data: Dict[str, torch.Tensor]) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self.backbone(data)[OUT_FIELD]
        out = self.plan.apply(x, self.w_out)
        if self.output_format == "cartesian" and self.output_formula != "scalar":
            out = cartesian_tensor_map(self.output_formula).to_cartesian(out)
        if not self.scalar_target_names:
            return out
        preds = {self.tensor_target_name: out}
        for name in self.scalar_target_names:
            preds[name] = self.scalar_plan.apply(x, getattr(self, f"w_{name}"))
        return preds


class AtomicTensorModel(torch.nn.Module):
    """Per-node tensor prediction: the backbone's NodewiseLinear head maps
    into the target irreps ([num_nodes, dim], a row per padded node too);
    no pooling, no extra head; optional Cartesian readout."""

    def __init__(self, backbone: Sequential, output_formula: str = "ij=ji",
                 output_format: str = "irreps"):
        super().__init__()
        self.backbone = backbone
        self.output_formula = output_formula
        self.output_format = output_format

    def forward(self, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = self.backbone(data)[OUT_FIELD]
        if self.output_format == "cartesian" and self.output_formula != "scalar":
            out = cartesian_tensor_map(self.output_formula).to_cartesian(out)
        return out


def create_scalar_tensor_model(
    hparams: Dict[str, Any],
    dataset_hparams: Dict[str, Any],
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> ScalarTensorModel:
    """Build the model with N(0, 1) weights from `torch.Generator(seed)` on
    `device` (default: the card; pass "cpu" for the CPU)."""
    generator = torch.Generator().manual_seed(seed)
    hidden = Irreps(hparams["conv_to_output_hidden_irreps_out"])
    backbone = create_tfn_backbone(
        hparams,
        dataset_hparams,
        head_irreps=hidden,
        pooling=hparams.get("reduce", "mean"),
        generator=generator,
    )
    model = ScalarTensorModel(
        backbone,
        hidden,
        generator,
        output_formula=hparams.get("output_formula", "ijkl=jikl=klij").lower(),
        output_format=hparams.get("output_format", "irreps"),
        tensor_target_name=hparams.get("tensor_target_name", "elastic_tensor_full"),
        scalar_target_names=tuple(hparams.get("scalar_target_names", ()) or ()),
    )
    return model.to(device)


def create_atomic_tensor_model(
    hparams: Dict[str, Any],
    dataset_hparams: Dict[str, Any],
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> AtomicTensorModel:
    """Build the per-atom model with N(0, 1) weights from
    `torch.Generator(seed)` on `device` (default: the card; pass "cpu" for
    the CPU)."""
    generator = torch.Generator().manual_seed(seed)
    formula = hparams.get("output_formula", "ij=ji").lower()
    backbone = create_tfn_backbone(
        hparams,
        dataset_hparams,
        head_irreps=_target_irreps(formula),
        pooling=None,
        generator=generator,
    )
    model = AtomicTensorModel(
        backbone,
        output_formula=formula,
        output_format=hparams.get("output_format", "irreps"),
    )
    return model.to(device)
