"""Serving API: structures -> predicted Cartesian tensors.

Counterpart of `matten_tpu/predict.py::predict` for a model already in
memory: structures go through `CrystalGraph.from_structure`, then
`pad_spec_for` + `collate_graphs`, then the forward under
`torch.inference_mode()`, then the optional `MeanNormNormalize.inverse`,
then the Cartesian readout (`ElasticTensor` for [3, 3, 3, 3] outputs).
Structures whose graph cannot be built come back as None.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from matten_tpu_torch.data.graph import CrystalGraph, collate_graphs, pad_spec_for
from matten_tpu_torch.data.neighborlist import NeighborListError
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.data.transform import MeanNormNormalize
from matten_tpu_torch.ops.elasticity import ElasticTensor
from matten_tpu_torch.models.tfn import ScalarTensorModel
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.ops.cartesian import cartesian_tensor_map

logger = logging.getLogger(__name__)

__all__ = ["predict", "check_species", "batch_to_device"]


def check_species(structures: Sequence[Structure], allowed_species) -> None:
    """Fail fast if a structure contains species the model was not built for."""
    allowed = set(int(z) for z in allowed_species)
    for i, s in enumerate(structures):
        bad = set(int(z) for z in s.atomic_numbers) - allowed
        if bad:
            raise ValueError(
                f"structure {i} contains species (Z={sorted(bad)}) the model was "
                f"not trained on; supported: {sorted(allowed)}"
            )


def batch_to_device(data, device, targets=None):
    """Collated numpy batch -> dict of tensors on `device`; with the targets
    dict of the same collation, (data, targets) both on `device`."""
    moved = {k: torch.as_tensor(v).to(device) for k, v in data.items()}
    if targets is None:
        return moved
    return moved, {k: torch.as_tensor(v).to(device) for k, v in targets.items()}


def predict(
    structures: Union[Structure, dict, Sequence[Union[Structure, dict]]],
    model: ScalarTensorModel,
    statistics: Optional[MeanNormNormalize] = None,
    batch_size: int = 32,
    device: Union[str, torch.device, None] = None,
    r_cut: float = 5.0,
) -> Union[Optional[np.ndarray], List[Optional[np.ndarray]]]:
    """Predict the target tensor of one or more structures.

    `structures` are `Structure` objects or pymatgen `Structure.as_dict()`
    payloads. `statistics` is the target normalizer the model was trained
    with (None: outputs are already in target units). `device` defaults to
    the model's. Returns a Cartesian tensor per structure (an
    `ElasticTensor` for elasticity), None where graph construction failed.
    """
    single = not isinstance(structures, (list, tuple))
    if single:
        structures = [structures]
    structures = [s if isinstance(s, Structure) else Structure.from_dict(s) for s in structures]
    if model.output_format != "irreps":
        raise ValueError("predict() reads irreps outputs; build the model with output_format='irreps'")
    if device is None:
        device = next(model.parameters()).device
    species = model.backbone.layers[0].allowed_species
    check_species(structures, species)

    graphs, ok = [], []
    for i, s in enumerate(structures):
        try:
            graphs.append(CrystalGraph.from_structure(s, r_cut=r_cut))
            ok.append(i)
        except NeighborListError as e:
            logger.warning("structure %d failed graph conversion: %s", i, e)
    if not graphs:
        raise RuntimeError("Cannot successfully convert any structures.")
    species_map = atomic_number_map(species)
    cmap = cartesian_tensor_map(model.output_formula)

    model.eval()
    results: List[np.ndarray] = []
    with torch.inference_mode():
        for i in range(0, len(graphs), batch_size):
            chunk = graphs[i : i + batch_size]
            data, _ = collate_graphs(chunk, pad_spec_for(chunk), species_map=species_map)
            out = model(batch_to_device(data, device))
            out = out[: len(chunk)].double().cpu().numpy()
            if statistics is not None:
                out = np.asarray(statistics.inverse(out))
            for v in out:
                cart = cmap.to_cartesian(torch.from_numpy(v)).numpy()
                results.append(ElasticTensor(cart) if cart.shape == (3, 3, 3, 3) else cart)

    final: List[Optional[np.ndarray]] = [None] * len(structures)
    for i, r in zip(ok, results):
        final[i] = r
    if len(ok) < len(structures):
        logger.warning("%d structures failed conversion -> None", len(structures) - len(ok))
    return final[0] if single else final
