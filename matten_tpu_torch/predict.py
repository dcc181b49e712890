"""Serving API: structures -> predicted Cartesian tensors.

Counterpart of `matten_tpu/predict.py`. `predict(structures,
checkpoint_dir)` serves a trained model from its directory: the sidecars
(`hparams.json`, `dataset_statistics.npz`) rebuild the dataset config, the
statistics and the model of the right family, and the weights come from
the best epoch of `index.json`, else from `last` (`load_pretrained`). The
same call takes a model already in memory, `predict(structures, model,
statistics)`. Structures go through `load_tensor_dataset` (graphs at the
checkpoint's r_cut), then chunk by chunk of `batch_size`: `pad_spec_for` +
`collate_graphs`, the host check of the chunk's edges (`edge_plan`'s, before
the copy), a pinned non-blocking copy to the device, the forward in eval
mode under `torch.inference_mode()`, the optional
`MeanNormNormalize.inverse`, and the Cartesian readout (`_readout`): a
tensor per crystal for the graph-level model (an `ElasticTensor` for [3, 3,
3, 3]), [n_atoms, 3, 3] per crystal for the per-atom model. Structures
whose graph cannot be built come back as None.

The forward runs eagerly, chunk by chunk. The JAX `predict` compiles its
`fwd` once per pad shape per call; the port's counterpart, a CUDA graph per
pad shape for the length of a call, is left out: a call's chunks rarely
share a pad shape (buckets of 64 nodes and 512 edges), so a call captures
few graphs and replays fewer, and each would hold a memory pool for the
rest of the call (PERF.md, the serving entry).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from matten_tpu_torch.data.dataset import DatasetStatistics, TensorDatasetConfig, load_tensor_dataset
from matten_tpu_torch.data.graph import collate_graphs, pad_spec_for
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.data.transform import MeanNormNormalize
from matten_tpu_torch.models.tfn import (
    AtomicTensorModel,
    ScalarTensorModel,
    create_atomic_tensor_model,
    create_scalar_tensor_model,
)
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.ops.cartesian import cartesian_tensor_map
from matten_tpu_torch.ops.elasticity import ElasticTensor
from matten_tpu_torch.parallel.sharding import check_block_edges
from matten_tpu_torch.train.checkpoint import CheckpointManager, load_sidecar

logger = logging.getLogger(__name__)

__all__ = ["predict", "load_pretrained", "model_from_sidecar", "check_species", "batch_to_device"]

Model = Union[ScalarTensorModel, AtomicTensorModel]


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
    dict of the same collation, (data, targets) both on `device`. To the
    card each field goes from pinned memory without a host sync (the
    device's stream orders the copy before the work queued after it)."""
    device = torch.device(device)

    def put(v):
        t = torch.as_tensor(v)
        return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)

    moved = {k: put(v) for k, v in data.items()}
    if targets is None:
        return moved
    return moved, {k: put(v) for k, v in targets.items()}


def model_from_sidecar(
    hparams: Dict[str, Any], statistics_arrays: Dict[str, np.ndarray], device
) -> Tuple[Model, TensorDatasetConfig, DatasetStatistics]:
    """(model with fresh weights on `device`, dataset config, statistics) as
    a checkpoint's sidecars describe them; `cfg.per_atom` picks the family.
    The graph-level model gets the scalar heads of the data section's
    `scalar_target_names`, as the train script built it."""
    data_hp = hparams["data"]
    cfg = TensorDatasetConfig(
        r_cut=data_hp.get("r_cut", 5.0),
        tensor_target_name=data_hp.get("tensor_target_name", "elastic_tensor_full"),
        tensor_target_format=data_hp.get("tensor_target_format", "irreps"),
        tensor_target_formula=data_hp.get("tensor_target_formula", "ijkl=jikl=klij"),
        atom_selector=data_hp.get("atom_selector"),
    )
    statistics = DatasetStatistics.from_arrays(statistics_arrays, cfg)
    model_hp = dict(hparams["model"])
    if cfg.per_atom:
        model = create_atomic_tensor_model(model_hp, hparams["dataset_hparams"], device=device)
    else:
        model_hp.update(tensor_target_name=cfg.tensor_target_name,
                        scalar_target_names=list(data_hp.get("scalar_target_names") or []))
        model = create_scalar_tensor_model(model_hp, hparams["dataset_hparams"], device=device)
    return model, cfg, statistics


def load_pretrained(
    checkpoint_dir: Union[str, Path], device: Union[str, torch.device, None] = None
) -> Tuple[Model, TensorDatasetConfig, DatasetStatistics, bool]:
    """Rebuild (model in eval mode with the checkpoint's weights, dataset
    config, statistics, whether the targets were normalized) on `device`
    (default: the card). The weights are those of the best epoch in
    `index.json`, else of `last`."""
    device = torch.device("cuda") if device is None else torch.device(device)
    hparams, stats_arrays = load_sidecar(checkpoint_dir)
    model, cfg, statistics = model_from_sidecar(hparams, stats_arrays, device)
    manager = CheckpointManager(checkpoint_dir)
    state = manager.restore(last=manager.best_epoch is None, device=device)
    model.load_state_dict(state["model"])
    normalize = bool(hparams.get("normalize_tensor_target", False))
    return model.eval(), cfg, statistics, normalize


def _served(model: Model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The model's tensor output on a chunk (the scalar heads beside it are
    not served)."""
    out = model(batch)
    return out[model.tensor_target_name] if isinstance(out, dict) else out


def _readout(out: torch.Tensor, chunk, per_atom: bool, normalizer, cmap) -> List[np.ndarray]:
    """A chunk's served rows read back to the host, the normalization
    undone and mapped to Cartesian tensors: one per crystal (an
    `ElasticTensor` for [3, 3, 3, 3]), [n_atoms, 3, 3] per crystal for the
    per-atom model (its real rows, graph after graph; padded rows dropped)."""
    out = out.double().cpu().numpy()
    if per_atom:
        counts = np.cumsum([g.num_nodes for g in chunk])
        rows = np.split(out[: counts[-1]], counts[:-1])
    else:
        rows = out[: len(chunk)]
    results = []
    for v in rows:
        if normalizer is not None:
            v = np.asarray(normalizer.inverse(v))
        cart = cmap.to_cartesian(torch.from_numpy(v)).numpy()
        results.append(ElasticTensor(cart) if cart.shape == (3, 3, 3, 3) else cart)
    return results


def predict(
    structures: Union[Structure, dict, Sequence[Union[Structure, dict]]],
    checkpoint_dir_or_model: Union[str, Path, Model],
    statistics: Optional[MeanNormNormalize] = None,
    batch_size: int = 32,
    device: Union[str, torch.device, None] = None,
    r_cut: Optional[float] = None,
) -> Union[Optional[np.ndarray], List[Optional[np.ndarray]]]:
    """Predict the target tensor of one or more structures.

    `structures` are `Structure` objects or pymatgen `Structure.as_dict()`
    payloads. `checkpoint_dir_or_model` is a checkpoint directory (served
    on `device`, default the card, with the checkpoint's own statistics and
    r_cut) or a model in memory (served on `device`, default the model's,
    with `statistics`, the target normalizer it was trained with or None,
    and `r_cut`, default 5.0). Returns a Cartesian tensor per structure
    (an `ElasticTensor` for elasticity; [n_atoms, 3, 3] for the per-atom
    model), None where graph construction failed: as in the JAX package,
    any error while a structure's graph is built gives None and a warning.
    """
    single = not isinstance(structures, (list, tuple))
    if single:
        structures = [structures]
    structures = [s if isinstance(s, Structure) else Structure.from_dict(s) for s in structures]
    if isinstance(checkpoint_dir_or_model, torch.nn.Module):
        model, normalizer = checkpoint_dir_or_model, statistics
        r_cut = 5.0 if r_cut is None else r_cut
        if device is None:
            device = next(model.parameters()).device
    else:
        if statistics is not None or r_cut is not None:
            raise ValueError("a checkpoint directory brings its own statistics and r_cut")
        model, cfg, stats, normalize = load_pretrained(checkpoint_dir_or_model, device)
        normalizer = stats.target_normalizer if normalize else None
        r_cut, device = cfg.r_cut, next(model.parameters()).device
    if model.output_format != "irreps":
        raise ValueError("predict() reads irreps outputs; build the model with output_format='irreps'")
    embedding = model.backbone.layers[0]
    if embedding.use_atom_feats or embedding.use_global_feats:
        raise ValueError(
            "predict() builds graphs from structures alone, and this model reads atom or global "
            "feature columns (use_atom_feats / use_global_feats); run it on collated batches "
            "that carry them (the JAX predict() fails on such a model too)"
        )
    species = embedding.allowed_species
    check_species(structures, species)
    graphs, failed = load_tensor_dataset(
        None, TensorDatasetConfig(r_cut=r_cut, tensor_target_name=None), structures=structures
    )
    species_map = atomic_number_map(species)
    cmap = cartesian_tensor_map(model.output_formula)
    per_atom = isinstance(model, AtomicTensorModel)

    model.eval()
    results: List[np.ndarray] = []
    with torch.inference_mode():
        for i in range(0, len(graphs), batch_size):
            chunk = graphs[i : i + batch_size]
            data, _ = collate_graphs(chunk, pad_spec_for(chunk), species_map=species_map)
            check_block_edges(None, data)
            out = _served(model, batch_to_device(data, device))
            results += _readout(out, chunk, per_atom, normalizer, cmap)

    final: List[Optional[np.ndarray]] = []
    it = iter(results)
    failed_set = set(failed)
    for i in range(len(structures)):
        final.append(None if i in failed_set else next(it))
    if failed:
        logger.warning("%d structures failed conversion -> None", len(failed))
    return final[0] if single else final
