"""What decides `correct`: the program's first three train steps and
three eval steps against the plain reference's.

Set-up drives the trainer that the window then uses through one epoch of
`Trainer.fit`, the window's own feed and call: three train batches of
distinct crystals (the train file's first three batches in file order),
each padded to the largest shape of the train loader's ladder, then three
validation batches (the validation file's first three, their targets
set to zero, so that an eval step's loss is its predictions' mean square
and not the targets') at the largest shape of the validation loader's
ladder. At each shape the first step runs
eagerly, the second is captured as a CUDA graph and the third replays it.
`ProgramReadings`, put in the place of the trainer's `train_step` and
`eval_step` for that epoch, keeps on the device each step's loss, Adam's
first moment after the first step and the parameters after the third.
Once the window has closed and the program's state is freed,
`reference_readings` reads the same dataset files with the reference's
own code (neighbour lists in numpy, statistics, target normalisation,
padding and masks), starts the reference model from the same weights,
takes the same three steps with `torch.optim.Adam` and evaluates the same
three validation batches.

The numbers compared (`compare`), each against its configuration's limit:
  * `loss_gap`: the largest relative gap of a train step's loss;
  * `grad_gap`: by the worst leaf, the gap between the two norms of the
    first gradient as Adam got it (its first moment over 1 - beta1, the L2
    term included), over the larger of the reference's norm of that leaf
    and of the median leaf;
  * `change_gap`: the same for the parameters' change over the three
    steps, leaving out the leaves whose reference gradient is under a
    thousandth of the median leaf's, which Adam moves by round-off alone;
  * `eval_gap`: the largest relative gap of an eval step's loss (the mean
    square of its predictions), on the running statistics and parameters
    that the three steps left.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["ProgramReadings", "Readings", "ReferenceData", "reference_readings", "compare", "judge", "STEPS"]

STEPS = 3
# below this share of the median leaf's reference gradient norm, a leaf's
# change is round-off (a bias that a softmax or a norm cancels)
NOUGHT = 1e-3


@dataclass
class Readings:
    """Per train step losses; per leaf the first gradient as Adam got it and
    the change after the steps; per eval step losses; float32 tensors on
    the device."""

    losses: torch.Tensor
    grad: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]
    eval_losses: torch.Tensor


class ProgramReadings:
    """Snapshots of a trainer's state as its first steps run (module
    docstring); clones on the device, so no step waits for the host.
    `attach` puts `train_step` and `eval_step` in the place of the
    trainer's own, which they call; `detach` gives the trainer back its own."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.params = dict(trainer.model.named_parameters())
        self.start = {n: p.detach().clone() for n, p in self.params.items()}
        self.losses: List[torch.Tensor] = []
        self.eval_losses: List[torch.Tensor] = []
        self.grad: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}

    def attach(self) -> None:
        self._train, self._eval = self.trainer.train_step, self.trainer.eval_step
        self.trainer.train_step, self.trainer.eval_step = self.train_step, self.eval_step

    def detach(self) -> None:
        del self.trainer.train_step, self.trainer.eval_step

    def train_step(self, data, targets):
        out = self._train(data, targets)
        self.losses.append(out[0].detach().float().reshape(()).clone())
        if len(self.losses) == 1:
            beta1 = self.trainer.optimizer.param_groups[0]["betas"][0]
            state = self.trainer.optimizer.state
            # a step that left the optimizer without state got no gradient
            self.grad = {n: state[p]["exp_avg"].detach().clone() / (1 - beta1) if "exp_avg" in state.get(p, {})
                         else torch.zeros_like(p) for n, p in self.params.items()}
        if len(self.losses) == STEPS:
            self.after = {n: p.detach().clone() for n, p in self.params.items()}
        return out

    def eval_step(self, data, targets):
        out = self._eval(data, targets)
        self.eval_losses.append(out[0].detach().float().reshape(()).clone())
        return out

    def readings(self) -> Readings:
        if len(self.losses) != STEPS or len(self.eval_losses) != STEPS:
            raise ValueError(f"the first epoch ran {len(self.losses)} train and {len(self.eval_losses)} eval "
                             f"steps, not {STEPS} of each")
        return Readings(torch.stack(self.losses), self.grad,
                        {n: self.after[n] - self.start[n] for n in self.start}, torch.stack(self.eval_losses))


def _tensor_batch(batch, device):
    return tuple({k: torch.as_tensor(np.asarray(v)).to(device) for k, v in part.items()} for part in batch)


class ReferenceData:
    """The reference's reading of a run's dataset files: its own graphs
    (numpy neighbour lists), the train file's statistics, and the targets
    normalised by them, by split and file row."""

    def __init__(self, config: dict, files: Dict[str, object]):
        from benchmark.reference.data.dataset import DatasetStatistics, TensorDatasetConfig, load_tensor_dataset

        data_cfg = config["data"]
        self.config = config
        self.name = data_cfg["tensor_target_name"]
        self.per_atom = config["family"] == "atomic"
        dcfg = TensorDatasetConfig(r_cut=data_cfg["r_cut"], tensor_target_name=self.name,
                                   tensor_target_format=data_cfg["tensor_target_format"],
                                   tensor_target_formula=data_cfg["tensor_target_formula"],
                                   atom_selector=data_cfg.get("atom_selector"))
        normalize = bool(data_cfg.get("normalize_tensor_target", False))
        self.by_row: Dict[str, Dict[int, object]] = {}
        for split in ("train", "val"):
            graphs, failed = load_tensor_dataset(files[split], dcfg)
            if split == "train":
                self.stats = DatasetStatistics.compute(graphs, dcfg, normalize)
            if normalize:
                for g in graphs:
                    g.y[self.name] = np.asarray(self.stats.target_normalizer.forward(g.y[self.name]))
            skipped = set(failed)
            rows = [i for i in range(len(graphs) + len(skipped)) if i not in skipped]
            self.by_row[split] = dict(zip(rows, graphs))


def reference_readings(ref: ReferenceData, rows: Dict[str, Sequence[Sequence[int]]],
                       weights: Dict[str, torch.Tensor], device: torch.device, tf32: bool = False,
                       half_batch: bool = False) -> Readings:
    """The reference's three train steps and three eval steps (module
    docstring) on the crystals of the dataset files' `rows` ({"train": a
    list of rows per step, "val": the same}), from `weights`. `tf32`: its
    float32 matmuls in TF32 (the control); `half_batch`: every loss over
    the first half of each batch's crystals only (a planted fault)."""
    from benchmark.reference.data.graph import collate_graphs, pad_spec_for
    from benchmark.reference.models.tfn import create_atomic_tensor_model, create_scalar_tensor_model
    from benchmark.reference.nn.embedding import atomic_number_map
    from benchmark.reference.train.task import masked_mse_sums

    config, name, per_atom = ref.config, ref.name, ref.per_atom
    dataset_hparams = {"allowed_species": list(ref.stats.allowed_species),
                       "average_num_neighbors": ref.stats.average_num_neighbors}
    create = create_atomic_tensor_model if per_atom else create_scalar_tensor_model
    species_map = atomic_number_map(ref.stats.allowed_species)
    per_node = frozenset({name, "atom_selector"}) if per_atom else frozenset()

    def loss_of(model, split, members):
        gs = [ref.by_row[split][i] for i in members]
        data, targets = _tensor_batch(collate_graphs(gs, pad_spec_for(gs), species_map=species_map,
                                                     per_node_keys=per_node), device)
        if split == "val":
            targets[name] = torch.zeros_like(targets[name])
        if per_atom:
            mask = data["node_mask"] & targets["atom_selector"].bool()
            if half_batch:
                mask = mask & (data["batch"] < len(gs) // 2)
        else:
            mask = data["graph_mask"].clone()
            if half_batch:
                mask[len(gs) // 2:] = False
        num, den = masked_mse_sums(model(data), targets[name], mask)
        return num / den.clamp_min(1.0)

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = create(dict(config["model"]), dataset_hparams, device=device, seed=0)
        params = dict(model.named_parameters())
        if set(params) != set(weights):
            raise ValueError(f"reference and program parameters differ: {sorted(set(params) ^ set(weights))}")
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(weights[n])
        tr = config["trainer"]
        opt = torch.optim.Adam(model.parameters(), lr=tr["lr"], weight_decay=tr["weight_decay"])
        start = {n: p.detach().clone() for n, p in params.items()}
        losses, grad = [], {}
        model.train()
        for k, members in enumerate(rows["train"][:STEPS]):
            opt.zero_grad(set_to_none=True)
            loss = loss_of(model, "train", members)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if k == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                grad = {n: opt.state[p]["exp_avg"].detach().clone() / (1 - beta1) for n, p in params.items()}
        change = {n: p.detach() - start[n] for n, p in params.items()}
        model.eval()
        with torch.no_grad():
            eval_losses = [loss_of(model, "val", members).detach() for members in rows["val"][:STEPS]]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return Readings(torch.stack(losses), grad, change, torch.stack(eval_losses))


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double().cpu()
    return float(((got.double().cpu() - want).abs() / want.abs().clamp_min(1e-300)).max())


def _leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], leaves: Sequence[str]) -> float:
    """By the worst leaf, |norm(got) - norm(want)| over the larger of the
    leaf's and the median leaf's norm of `want`."""
    g = torch.stack([got[n].double().norm() for n in leaves]).cpu()
    w = torch.stack([want[n].double().norm() for n in leaves]).cpu()
    scale = torch.maximum(w, w.median())
    return float(((g - w).abs() / scale.clamp_min(1e-300)).max())


def compare(program: Readings, reference: Readings) -> Dict[str, float]:
    """The four numbers of the module docstring."""
    leaves = sorted(reference.grad)
    norms = {n: float(reference.grad[n].double().norm()) for n in leaves}
    median = float(np.median(list(norms.values())))
    moved = [n for n in leaves if norms[n] >= NOUGHT * median]
    return {"loss_gap": _rel_gap(program.losses, reference.losses),
            "grad_gap": _leaf_gap(program.grad, reference.grad, leaves),
            "change_gap": _leaf_gap(program.change, reference.change, moved),
            "eval_gap": _rel_gap(program.eval_losses, reference.eval_losses)}


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    """Every number finite and within its limit."""
    return all(np.isfinite(v) and limits.get(k) is not None and v <= limits[k] for k, v in numbers.items())
