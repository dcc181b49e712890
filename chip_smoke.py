#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's serving paths, train steps, train scripts and parallel ranks once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is not 0):
  1. environment: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc builds the port's kernels from the sources in this checkout,
     one process per source, all started together;
  3. kernel parity: the fused uvu conv (K1: its item pass and the segment
     sum of its partial rows) against its plain PyTorch version at the 4
     conv-layer plans of the production elasticity model, on the flagship
     batch's real edges and its edge plan, seeded random x and w; at
     N = 2600 nodes with the last layer's plan (the regime where the JAX
     package leaves its resident-node kernels for K3); and on a skewed graph
     (one destination with 3000 edges, destinations without edges, whose
     rows must be 0); two runs bitwise equal; K1's grid, a static bound on
     its items (`fused_conv.item_bound`), bitwise the grid of the item
     count read back; the segment sum of K1's partial rows against
     index_add_ of the same rows;
  4. backward kernel parity at the same 4 plans with a seeded cotangent g
     and at N = 2600: the merged backward kernel's dw and per-edge dx rows
     against their plain versions, the dx segment sum against index_add_ of
     the same rows, dx and dw of `uvu_conv_bwd` against the plain backward,
     and two runs of `uvu_conv_bwd` bitwise equal;
  5. model: the production ScalarTensorModel (seeded random weights) on the
     flagship batch through K1 and through the plain conv; exactly 4 K1
     launches (item pass and partial-row sum) per forward;
  6. serving, the first main path: `matten_tpu_torch.predict.predict` on the
     32 flagship crystals plus Si; every result a finite [3, 3, 3, 3]
     tensor; launch counts set to 0 just before and read just after;
  7. train gradients: one step's parameter gradients through the kernels
     against a deep copy of the model under `force_plain()`;
  8. train step, the second main path: `Trainer.train_step` (Adam, lr 0.01)
     on the flagship batch and its targets, a few steps (the first eager,
     the second captured as a CUDA graph and replayed, the third replayed);
     exactly 4 launches per step of each of K1's item pass, the segment sum
     in its two roles (K1's partial rows, dx) and the merged backward;
     finite losses;
  9. timings with CUDA events, kernel against plain, interleaved: the
     forward and the train step; per layer K1 with its partial-row sum (on
     the batch's edge plan, as the model calls it), the merged backward
     (against the plain backward) and the segment sum in both roles
     (against the plain sum and index_add_ of the same rows); each beside
     its bound; K1's item pass on its static grid against the grid of its
     counted items; peak memory of a forward and a train step above what is
     resident before it;
 11. NMR kernel parity: the per-atom NMR model (the `model` section of
     scripts/configs/atomic_tensor.yaml, SH lmax 2) on its batch, the 16
     crystals `bench.py::build_batch(np.random.default_rng(2), 16,
     per_atom=True)` draws with an `atom_selector` marking the Si atoms: K1
     (item pass and partial-row sum), the merged backward and the dx sum at
     its 4 conv plans against their plain versions, two runs bitwise equal;
 12. NMR forward, the third main path: the `AtomicTensorModel` through the
     kernels and under `force_plain()`, exactly 4 launches of K1's two
     kernels per forward;
 13. NMR train step, the fourth main path: gradients against a deep copy
     under `force_plain()`, then `Trainer.train_step` (Adam, lr 0.01,
     weight decay 1e-5, the YAML's optimizer) a few steps, 4 launches of
     each counter per step, finite losses;
 14. from disk, the fifth main path: a checkpoint directory of each family
     (`CheckpointManager` + `save_sidecar`, a target normalizer from
     `DatasetStatistics.compute`; the elasticity one holds phase 5's
     weights), then `predict(structures, checkpoint_dir)` on the card, equal
     to the in-memory `predict` of the same weights, the kernels launched;
     the NMR results finite symmetric [n_atoms, 3, 3] arrays;
 15. NMR timings with CUDA events, interleaved: the forward and the train
     step against plain, per layer K1 (with its sum) and the merged
     backward against plain, each beside its bound;
 16. fit, elasticity, the sixth main path: data files in pandas' "records"
     layout (256 train crystals drawn as
     `bench.py::measure_fit_epoch_throughput` draws them,
     `np.random.default_rng(4)`, and 64 val/test crystals, rng 5; symmetric
     Cartesian `elastic_tensor_full` targets), then
     `matten_tpu_torch.scripts.train_materials_tensor.main` on the card with
     scripts/configs/materials_tensor_production.yaml as the port's reader
     loads it (the production model, batch 32, 4 buckets, normalized
     targets), 3 epochs: launches exactly 4 per train, val and test forward
     of K1's two kernels and 4 per train step of the backward's two; the
     checkpoint directory; finite history and test metrics;
     `predict(structures, directory)` on the card equal to the in-memory
     `predict` of the restored best model within 1e-6; a rerun with
     `restore: true` and one more epoch adds exactly that epoch; epoch
     times after the first, train edges/s and the setup time; then the
     kernels against their plain versions at this path's own batches: the
     restored best model's evaluation over the train, val and test batches
     against a copy under `force_plain()` (each metric within 1e-5
     relative), and one train step's gradients on the first train batch of
     each pad shape the loader gives (within 1e-4); the fit graphed at the
     yaml's `scan_steps: 8`; and the epoch's time with graphed steps
     against eager steps, both fed by the trainer's group copies,
     interleaved;
 17. fit, NMR, the seventh main path: the same with
     `train_atomic_tensor.main` and scripts/configs/atomic_tensor.yaml (its
     model, batch 2) on 32 crystals with an `atom_selector` column, 2
     epochs, at `scan_steps: 8` as the production yaml sets it; the NMR rows
     from disk finite symmetric [n_atoms, 3, 3]; the same checks against
     the plain versions at its batch-2 batches;
 18. the variants configuration, the eighth main path: the production model
     with instance norm, the norm activation, the gaussian basis, max
     pooling, an atom and a global feature column and a `k_voigt` head
     beside the tensor (task weights 1.0 / 0.5), on the flagship crystals
     with seeded features, `k_voigt` and target weights (8 all-padding
     graphs): its 4 conv plans beside the production ones, K1 (item pass
     and partial-row sum), the merged backward and the dx sum at them
     against their plain versions, two runs bitwise equal; the forward
     (both outputs) and one step's gradients of the weighted two-task loss
     against `force_plain()`, all finite; a few Adam steps with 4 launches
     of each counter per step; per-layer times against plain and bound;
 19. fit, variants, the ninth main path: `train_materials_tensor.main` on
     the card with materials_tensor_production.yaml and the variants
     overrides (the data: both feature columns standardized, `k_voigt`
     logged and standardized, the tensor scaled by 0.1, weights from a
     string column), 256 + 64 crystals drawn as in phase 16 with those
     columns, 3 epochs: exact launches, both tasks' MAE in a finite
     history; `predict(structures, directory)` refuses the model (it reads
     feature columns, which structures alone lack; the JAX `predict` fails
     on it), and the directory's model (`load_pretrained`) on the test
     batches equals the in-memory best model within 1e-6; the evaluation
     and the gradients per pad shape against `force_plain()`; epoch times,
     train edges/s and the setup time;
 20. data parallel 2 x 1, the tenth main path: 2 ranks started as processes
     (`parallel.launch`) that share the card under the gloo backend, each
     taking its block of the port loader's stacked flagship batch (2 x 16
     crystals) through `Trainer(mesh=...).train_step` (SGD, lr 0.01) at
     production width without batch norm (data parallelism normalizes each
     shard by its own statistics, so only then is it the 1-rank step), and a
     ragged batch, one crystal over the 2 ranks: the loss and metric sum
     within 1e-5 relative of the 1-rank step on the whole batch, every
     gradient within MODEL_TOL of its largest entry, the parameters after
     the step within 2e-5, both ranks bitwise equal; exact launches per
     step and rank; each rank's K1 and backward (with their segment sums)
     against their plain versions at its own edge plans (KERNEL_TOL); their
     times per layer beside their bounds at the rank's shapes and the step
     time by CUDA events beside the 1-rank step's (both ranks at once on
     one card: checks of the path, not scaling); in the graph modes of
     phase 21 on the flagship batch also their plain versions' times and
     the conv kernels' device time per step (the profiler on each rank);
 21. graph parallel 1 x 2, the eleventh: the same for the modes edge, node
     and node_ring on the flagship batch with the production model (batch
     norm summed over the graph axis in the node modes), and node on the
     NMR batch with its per-atom loss; launches 4 per step of each counter,
     8 under node_ring (a plan per ring group);
 22. the materials script on a mesh, the twelfth: `train_materials_tensor.main`
     with materials_tensor_production.yaml and `trainer.mesh: {data: 1,
     graph: 2, mode: node}` on 2 ranks, phase 16's data, 2 epochs: exact
     launches per rank, test metrics equal on both ranks, the directory
     rank 0 alone wrote served by `predict` equal (1e-6) to rank 0's
     in-memory best weights in the one-device model its sidecars describe;
     on each rank, the kernels against `force_plain()` at the fit's own
     blocks: the best model's evaluation of each split (FIT_EVAL_TOL, K1
     once per conv layer and batch), one step's gradients summed over the
     ranks on the first block of each pad shape (MODEL_TOL), and K1 and the
     backward at each such block's plans (KERNEL_TOL).
 23. bf16 storage, the thirteenth: with `set_kernel_in_dtype("bfloat16")`
     K1 and the merged backward read sh and w stored as bf16: both (with
     their segment sums) against their plain versions at the same rounding
     (KERNEL_TOL, two runs bitwise equal) at the 4 flagship and the 4 NMR
     plans and at N = 2600; the flagship forward and one step's gradients
     against the kernels at float32 storage (bf16 noise, max|d| /
     max(max|ref|, 1) <= 3e-2, the JAX package's bf16-storage test); the
     forward and a train step counted, exactly 4 launches of each bf16
     counter; per-layer times against the plain versions at bf16, beside
     bounds with sh and w at 2 bytes; the forward, the train step and the
     conv kernels' device time per step (the profiler) at bf16 against
     float32 in the same call. Every bf16 setting is reset on the way out;
 24. DEBUG and timing: the production model built at DEBUG log level (a
     `DetectAnomaly` after every backbone layer) with the INFO model's
     weights gives its output bitwise; a NaN put into one node feature
     after the first layer raises FloatingPointError naming the field and
     the layer; one `StepTimer` step reports edges/s; `profile_trace`
     writes a Chrome trace;
 25. plans past production, the fourteenth: the three WIDE_CONFIGS (SH up
     to l=5; the conv multiplicities doubled; SH up to l=5 with 4o/4e/5o/5e
     conv irreps), whose plans pass the 227 KiB a block may have or hold
     irreps above l=4, at full depth on the flagship batch with seeded
     weights: each layer's kernel tiers and bytes per block at float32 and
     bf16 storage; K1 (item pass and sum) and the merged backward (with the
     dx sum) at each layer's plan against their plain versions at both
     storage widths (KERNEL_TOL, two runs bitwise equal); the forward
     against `force_plain()` (MODEL_TOL) and 2 Adam steps, each step's
     gradients against `force_plain()` (MODEL_TOL), with exact launches per
     tier; per layer the kernels' ms per call against one plain call and
     the bound, and their device ms per train step (the profiler).
 26. compiled steps, the fifteenth: the train and eval steps as CUDA graph
     replays (`train/graphs.py`), on the flagship batch with the production
     model and on the NMR batch with the NMR model, each at full width: a
     graphed trainer against an eager one (its `_graphs` None) from the
     same state, step for step: 8 train steps with the lr halved after step 4,
     then a second pad shape (half the crystals) and the first again, then
     `load_state_dict` and 2 steps, then 3 eval steps; every loss and metric
     sum within 1e-5 relative, the parameters and Adam moments within
     MODEL_TOL; every replay under `set_sync_debug_mode("error")` with
     exactly 4 launches of each kernel; host ms per step (synced wall) and
     the device's busy share of a profiled step, graphed against eager, with
     each kind's conv kernels found in the profiled steps' trace equal to
     what the counters added (4 per step: a replay's count is its
     capture's, so the trace is what shows the graph ran them); the bytes
     of the graphs' pools and the capture time of each key.
The line before the last is the kernels JSON (its times are phase 9's; its
max |d| the worst of the script's direct comparisons of a kernel with its
plain version, phases 20-22's included; its launches count every main
path's run: phases 6, 8, 12-14, 16-19, the graphed trainers of 26 and,
summed over both ranks, 20-22; the two bf16-storage entries' times,
bounds, max |d| and launches are phase 23's; the last two entries, K1 and the merged
backward at the plans past production, are phase 25's, with their
launches per tier and their max |d| at bf16 storage beside); the last line is
{"ok": true, "device": {...}}. There is no CPU path: without CUDA the
script fails. The run uses one card: only the first visible device is
left visible.

    python3 chip_smoke.py --profile DIR

adds phase 10, where the time of a forward and of a train step goes: host
wall per forward and per step, per backbone layer, the step's forward /
backward / optimizer split, and torch.profiler traces (device ops, device
busy time, host launches, device time of each kernel), written to DIR; the
device time per layer of K1, its item pass, the segment sum in both roles
and index_add_ of the same rows, with the L2 cache warm and flushed; and
the same train-step profile of the NMR model and of the variants model
(each conv kernel's device time per layer at its plans).

    python3 chip_smoke.py --cards N

(N >= 2; on a machine with N cards) keeps N cards visible and runs, in
place of phases 3-24, data and graph parallelism with one rank per card
under nccl (`parallel.launch` with backend "nccl": rank r on cuda:r,
`LOCAL_RANK` r), the kernels built once before any rank starts: the step
cases of `card_cases(N)` (data parallel N x 1 without batch norm, edge,
node and node_ring at 1 x N, node at 2 x N/2 without batch norm, node on
the NMR batch at 1 x N, node at 1 x N with max pooling: pmax across the
cards) held as phases 20-21 hold theirs against the 1-rank step computed
meanwhile on card 0, each rank's kernels against
plain at its own plans, no rank staging through the host; each case's
step time per rank (CUDA events) beside the 1-rank step's, the conv and
NCCL kernels' device time per step on rank 0 (the profiler); then
`torchrun --standalone --nproc-per-node N -m
matten_tpu_torch.scripts.train_materials_tensor CONFIG` on the production
yaml with `trainer.mesh: {data: 1, graph: N, mode: node}`, phase 16's
data, 2 epochs, against the same config fitted on card 0 (every epoch's
loss and val score and the test metrics within 1e-4 relative, the same
directory, `predict` from both within 1e-5, no NCCL warning of a guessed
device). It prints the N cards' nvidia-smi lines and ends with the same
last line, with "count": N.

The flagship batch is the one `bench.py::build_batch` draws
(np.random.default_rng(0), 32 crystals of 4-12 atoms over 5 species,
r_cut 5.0, an `elastic_tensor_full` target of 21 values per crystal),
collated with `pad_spec_for` + `collate_graphs`.
"""

import argparse
import ast
import contextlib
import copy
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

SPECIES_5 = (8, 13, 14, 22, 56)

# the production elasticity configuration
# (scripts/configs/materials_tensor_production.yaml, bench.py HPARAMS)
HPARAMS = dict(
    species_embedding_dim=16,
    irreps_edge_sh="0e+1o+2e+3o+4e",
    num_radial_basis=8,
    radial_basis_start=0.0,
    radial_basis_end=5.0,
    radial_basis_type="bessel",
    num_layers=3,
    invariant_layers=2,
    invariant_neurons=32,
    average_num_neighbors=30.0,
    conv_layer_irreps="32x0o+32x0e+16x1o+16x1e+4x2o+4x2e+2x3o+2x3e+2x4e",
    nonlinearity_type="gate",
    normalization="batch",
    conv_to_output_hidden_irreps_out="16x0e+2x2e+4e",
    output_format="irreps",
    output_formula="ijkl=jikl=klij",
    reduce="mean",
)
DATASET_HPARAMS = dict(allowed_species=list(SPECIES_5), average_num_neighbors=30.0)
# phase 25: the production configuration past its shared-memory needs, as
# users widen it: SH up to l=5 ("sh5"), the conv multiplicities doubled
# ("x2"), and SH up to l=5 with 4o/4e/5o/5e conv irreps ("sh5conv5"); the
# conv kernels run them at smaller tiers
SH5 = "0e+1o+2e+3o+4e+5o"
WIDE_CONFIGS = {
    "sh5": dict(HPARAMS, irreps_edge_sh=SH5),
    "x2": dict(HPARAMS, conv_layer_irreps="64x0o+64x0e+32x1o+32x1e+8x2o+8x2e+4x3o+4x3e+4x4e"),
    "sh5conv5": dict(HPARAMS, irreps_edge_sh=SH5,
                     conv_layer_irreps="32x0o+32x0e+16x1o+16x1e+4x2o+4x2e+2x3o+2x3e+2x4o+2x4e+2x5o+2x5e"),
}
# the per-atom NMR configuration: the `model` section of
# scripts/configs/atomic_tensor.yaml; "auto" takes the batch's own average
# number of neighbours, as the data module hands it to the model
NMR_HPARAMS = dict(
    species_embedding_dim=16,
    irreps_edge_sh="0e+1o+2e",
    radial_basis_type="bessel",
    num_radial_basis=8,
    radial_basis_start=0.0,
    radial_basis_end=5.0,
    num_layers=3,
    invariant_layers=2,
    invariant_neurons=32,
    average_num_neighbors="auto",
    conv_layer_irreps="32x0o+32x0e+16x1o+16x1e+4x2o+4x2e",
    nonlinearity_type="gate",
    normalization="batch",
    output_format="irreps",
    output_formula="ij=ji",
)
NMR_TARGET = "nmr_tensor"
SI = 14  # the NMR targets are Si shieldings: the atom selector marks the Si atoms

# kernel vs plain: f32 with another summation order (per-edge CG contraction
# and per-row sums vs einsum + index_add), max|d| relative to max|ref|
KERNEL_TOL = 1e-5
# whole model: the same difference carried through 4 convs, gates and BN;
# parameter gradients of a train step, each relative to its largest entry
MODEL_TOL = 1e-4
SEED = 0
WARMUP, REPS = 3, 20
GRID_LOOP = 20  # K1 launches per timed run when its static grid is timed against the counted one
TRAIN_STEPS = 3
TARGET = "elastic_tensor_full"
# the `data` sidecar entries a checkpoint of each family carries
ELASTIC_DATA = dict(r_cut=5.0, tensor_target_name=TARGET)
NMR_DATA = dict(r_cut=5.0, tensor_target_name=NMR_TARGET, tensor_target_formula="ij=ji",
                atom_selector="atom_selector")
BIG_N = 2600  # beyond the JAX package's resident-node limit of 2048
BIG_DEGREE = 64
SKEW_DEGREE, SKEW_EMPTY, SKEW_REST = 3000, 16, 1237  # E = 4237, no multiple of 16

# one H100 SXM, NVIDIA's data sheet: HBM rate and float32 peak outside the
# tensor cores (the kernels run in float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def draw_structures(seed=0, n_graphs=32, per_atom=False, atoms_lo=4, atoms_hi=12):
    """The crystals of `bench.py::build_batch(np.random.default_rng(seed),
    n_graphs, per_atom=per_atom)`, drawn in the same order (each target
    right after its crystal), and their targets: [1, 21] per crystal, or
    [n, 6] per atom."""
    from matten_tpu_torch.data.structure import Structure

    rng = np.random.default_rng(seed)
    structures, targets = [], []
    for _ in range(n_graphs):
        n = int(rng.integers(atoms_lo, atoms_hi + 1))
        structures.append(
            Structure(
                lattice=np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1,
                frac_coords=rng.uniform(0, 1, size=(n, 3)),
                atomic_numbers=rng.choice(SPECIES_5, size=n),
            )
        )
        targets.append(rng.normal(size=(n, 6) if per_atom else (1, 21)))
    return structures, targets


def si_structure():
    from matten_tpu_torch.data.structure import Structure

    return Structure(
        lattice=np.array([[0, 2.73, 2.73], [2.73, 0, 2.73], [2.73, 2.73, 0]]),
        frac_coords=[[0, 0, 0], [0.25, 0.25, 0.25]],
        atomic_numbers=[14, 14],
    )


def graphs_of(structures, targets, target=TARGET, selected=None):
    """Graphs at r_cut 5.0 with their targets. With `selected`, a per-atom
    target and an `atom_selector` that marks the atoms of that atomic
    number, whose rows alone carry the target (a dataset's dense layout)."""
    from matten_tpu_torch.data.graph import CrystalGraph

    graphs = []
    for s, y in zip(structures, targets):
        g = CrystalGraph.from_structure(s, r_cut=5.0)
        if selected is not None:
            sel = s.atomic_numbers == selected
            g.y["atom_selector"] = sel
            y = np.where(sel[:, None], y, 0.0)
        g.y[target] = y
        graphs.append(g)
    return graphs


def collate(structures, targets, target=TARGET, selected=None):
    """(data, targets) numpy dicts of one padded batch."""
    from matten_tpu_torch.data.graph import collate_graphs, pad_spec_for
    from matten_tpu_torch.nn.embedding import atomic_number_map

    graphs = graphs_of(structures, targets, target, selected)
    return collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(SPECIES_5))


def cuda_ms(fn, torch):
    """Milliseconds of one call of fn, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def interleaved(fa, fb, torch):
    """Median ms of fa and fb, timed in turns (a b, b a, ...) after warm-up."""
    for _ in range(WARMUP):
        fa(), fb()
    ta, tb = [], []
    for r in range(REPS):
        if r % 2 == 0:
            ta.append(cuda_ms(fa, torch))
            tb.append(cuda_ms(fb, torch))
        else:
            tb.append(cuda_ms(fb, torch))
            ta.append(cuda_ms(fa, torch))
    return float(np.median(ta)), float(np.median(tb))


def conv_layers(model):
    """The 4 PointConv modules of the backbone, in order."""
    from matten_tpu_torch.nn.conv import PointConv, PointConvWithActivation

    out = []
    for m in model.backbone.layers:
        if isinstance(m, PointConvWithActivation):
            out.append(m.conv)
        elif isinstance(m, PointConv):
            out.append(m)
    return out


def kernel_work(plan, n_in, n_out, n_edges, n_items, in_bytes=4):
    """(bytes, float32 operations) each kernel's function needs at one
    layer: every input read once and every output written once, sh and w
    at their storage width `in_bytes` (4: float32, 2: bf16), everything
    else float32; operations as the kernels' arithmetic counts them (2 per
    multiply-add, 1 per add).
    "fwd" is K1's function, x, sh, w, src, dst -> out (its partial rows are
    a cost of the implementation, not work of the function); "bwd" the
    whole merged backward, g, sh, w, x, src, dst -> dx, dw; "fwd_sum" the
    segment sum of K1's partial rows alone, partial, item_ptr -> out;
    "dx_sum" the dx segment sum alone, dxe, perm, row_ptr -> dx."""
    from matten_tpu_torch.kernels.fused_conv import kernel_tables

    tab = kernel_tables(plan)
    d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
    sh_terms = int(tab.t_meta[:, 2].sum())  # multiply-adds of t_e = C . sh per edge
    x_terms = int((tab.out_meta[:, 3] & 0xFFFF).sum())  # sum over outputs of d1
    w_terms = int(((tab.out_meta[:, 3] & 0xFFFF) / (tab.out_meta[:, 3] >> 16)).sum())  # sum over weights of d1
    edge_idx = 2 * 4 * n_edges  # src, dst int32
    return {
        "fwd": (4 * (n_in * d1 + n_out * dout) + in_bytes * n_edges * (d2 + dw) + edge_idx,
                n_edges * 2 * (sh_terms + x_terms + dout) + n_out * dout),
        "bwd": (4 * (n_out * dout + n_in * d1 + n_in * d1 + n_edges * dw)
                + in_bytes * n_edges * (d2 + dw) + edge_idx,
                n_edges * 2 * (sh_terms + x_terms + 2 * w_terms)),
        "fwd_sum": (4 * (n_items * dout + n_out + 1 + n_out * dout), n_items * dout),
        "dx_sum": (4 * (n_edges * d1 + n_edges + n_in + 1 + n_in * d1), n_edges * d1),
    }


def bound_ms(nbytes, flops):
    """Least time of the card for the work: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_by(per_layer):
    """What bounds the layers' summed least time: the kind of the larger share."""
    share = {"bytes": 0.0, "operations": 0.0}
    for t, by in per_layer:
        share[by] += t
    return max(share, key=share.get)


def step_grads(trainer, data, targets):
    """One train-mode forward and backward: (loss, parameter gradients);
    with a mesh, the gradients summed over the ranks as a step sums them."""
    trainer.model.train()
    trainer.model.zero_grad(set_to_none=True)
    loss = trainer._compute_loss(trainer._preds(data), data, targets)
    loss.backward()
    if trainer.mesh is not None:
        trainer._reduce_across_ranks()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}


def own_peak_mib(fn, torch):
    """MiB that fn's run adds at its peak to what is allocated before it."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**20


def rel_err(out, ref):
    return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


# each kernel's launch counter in kernels/fused_conv.py; "fwd_sum" and
# "dx_sum" are the two roles of the one segment sum kernel
COUNTERS = {"fwd": "launches", "fwd_sum": "fwd_sum_launches", "bwd": "bwd_launches",
            "dx_sum": "dx_sum_launches"}
# the bf16-storage instances of K1's item pass and the merged backward
# (phase 23); their segment sums count in COUNTERS
BF16_COUNTERS = {"fwd_bf16": "bf16_launches", "bwd_bf16": "bf16_bwd_launches"}


def counts(fused_conv, counters=COUNTERS):
    return {k: getattr(fused_conv, c) for k, c in counters.items()}


def reset_counts(fused_conv):
    for c in (*COUNTERS.values(), *BF16_COUNTERS.values()):
        setattr(fused_conv, c, 0)
    fused_conv.tier_launches.clear()


PROFILED_FORWARDS = 5
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
# what each kind's kernel name holds in a trace: the segment sum runs its
# two roles as two instances of one template, segment_sum_kernel<V, PERM>
KERNEL_NAMES = {"fwd": ("fused_uvu_conv_fwd",), "fwd_sum": ("segment_sum_kernel", "false>"),
                "bwd": ("fused_uvu_conv_bwd",), "dx_sum": ("segment_sum_kernel", "true>")}


def is_kind(name, kind):
    return all(p in name for p in KERNEL_NAMES[kind])


def traced(fn, n, out_dir, name, torch):
    """Run fn n times under torch.profiler; write the tables and the trace
    to out_dir; return the trace's complete events and per-run device stats.

    Device numbers come from the trace's "kernel", "gpu_memcpy" and
    "gpu_memset" events only; the "gpu_user_annotation" ranges that labels
    add on the device side span kernels and are kept out of every count and
    sum."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    by_device = ("self_device_time_total" if hasattr(ka[0], "self_device_time_total")
                 else "self_cuda_time_total")
    (out_dir / f"{name}_table.txt").write_text(
        ka.table(sort_by=by_device, row_limit=40) + "\n\n"
        + ka.table(sort_by="cpu_time_total", row_limit=40))
    trace = out_dir / f"{name}_trace.json"
    prof.export_chrome_trace(str(trace))
    ev = json.loads(trace.read_text())
    ev = [e for e in (ev["traceEvents"] if isinstance(ev, dict) else ev) if e.get("ph") == "X"]
    dev_ops = sorted((e for e in ev if e.get("cat") in DEVICE_OPS), key=lambda e: e["ts"])
    busy, end = 0.0, -1.0  # union of device intervals, us
    for e in dev_ops:
        s, t = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    stats = {c: sum(e["cat"] == c for e in dev_ops) / n for c in DEVICE_OPS}
    stats["span_ms"] = (dev_ops[-1]["ts"] + dev_ops[-1]["dur"] - dev_ops[0]["ts"]) / n / 1e3
    stats["busy_ms"] = busy / n / 1e3
    stats["launches"] = sum(e.get("cat") == "cuda_runtime" and e["name"].startswith("cudaLaunchKernel")
                            for e in ev) / n
    per_name = {}
    for e in dev_ops:
        if e["cat"] == "kernel":
            per_name[e["name"]] = per_name.get(e["name"], 0.0) + e["dur"] / n / 1e3
    stats["by_kernel"] = per_name
    stats["per_layer"] = {
        k: [float(np.mean(v[i::4])) for i in range(4)] if len(v) >= 4 else []
        for k, v in ((k, [e["dur"] / 1e3 for e in dev_ops if is_kind(e["name"], k)])
                     for k in KERNEL_NAMES)
    }
    return ev, stats


def device_summary(st):
    return (f"{st['kernel']:g} kernels, {st['gpu_memcpy']:g} memcpys, {st['gpu_memset']:g} memsets, "
            f"{st['launches']:g} cudaLaunchKernel calls, device busy {st['busy_ms']:.4f} ms of a "
            f"{st['span_ms']:.4f} ms span ({100 * st['busy_ms'] / st['span_ms']:.1f}%)")


def profile_forward(model, fwd, data, out_dir, torch):
    """Phase 10a: where the time of one forward goes. Returns the line to print."""
    from torch.profiler import record_function

    from matten_tpu_torch.models.tfn import OUT_FIELD
    from matten_tpu_torch.nn import conv as conv_mod
    from matten_tpu_torch.nn.radial import ScalarMLP
    from matten_tpu_torch.ops.tensor_product import TensorProductPlan

    out_dir.mkdir(parents=True, exist_ok=True)
    wall = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    names = [type(m).__name__ for m in model.backbone.layers] + ["head"]
    layer_ms = np.zeros(len(names))
    for _ in range(REPS):
        d = dict(data)
        with torch.inference_mode():
            for i, layer in enumerate(list(model.backbone.layers) + [None]):
                t0 = time.perf_counter()
                if layer is None:
                    model.plan.apply(d[OUT_FIELD], model.w_out)
                else:
                    d = layer(d)
                torch.cuda.synchronize()
                layer_ms[i] += (time.perf_counter() - t0) * 1e3 / REPS

    def label(name, fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    # in a forward through K1, TensorProductPlan.apply runs only the
    # species FCTPs (sc, lin1, lin2 of each conv)
    patched = [(TensorProductPlan, "apply", "fctp"), (ScalarMLP, "forward", "radial_mlp"),
               (conv_mod, "fused_uvu_conv", "k1_wrapper")]
    saved = [getattr(obj, attr) for obj, attr, _ in patched]
    for (obj, attr, name), fn in zip(patched, saved):
        setattr(obj, attr, label(name, fn))
    try:
        ev, st = traced(fwd, PROFILED_FORWARDS, out_dir, "forward", torch)
    finally:
        for (obj, attr, _), fn in zip(patched, saved):
            setattr(obj, attr, fn)

    nf = PROFILED_FORWARDS
    per_label = []
    dev_ops = [e for e in ev if e.get("cat") in DEVICE_OPS]
    for _, _, name in patched:
        host = [e["dur"] for e in ev if e.get("cat") == "user_annotation" and e["name"] == name]
        dev = 0.0
        for g in (e for e in ev if e.get("cat") == "gpu_user_annotation" and e["name"] == name):
            dev += sum(e["dur"] for e in dev_ops if g["ts"] <= e["ts"] < g["ts"] + g["dur"])
        n = len(host)
        per_label.append(f"{name} {n / nf:g} calls/fwd, host {sum(host) / n / 1e3:.4f} ms/call, "
                         f"device {dev / n / 1e3:.4f} ms/call")

    return (
        f"[10 profile forward] host wall per forward (synced, unprofiled) ms: median "
        f"{np.median(wall):.4f} q1 {np.percentile(wall, 25):.4f} q3 {np.percentile(wall, 75):.4f}; "
        "per layer ms (synced): " + ", ".join(f"{n} {t:.4f}" for n, t in zip(names, layer_ms))
        + "; under the profiler, per forward: " + device_summary(st) + "; kernel ms per layer "
        + "; ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in st["per_layer"][k]) for k in ("fwd", "fwd_sum"))
        + "; " + "; ".join(per_label)
        + f"; trace and tables in {out_dir}"
    )


def profile_train(trainer, batch, out_dir, torch, name="train"):
    """Phase 10b: where the time of one train step goes. Returns the line."""
    data, targets = batch
    wall, split = [], np.zeros(3)
    for _ in range(REPS):
        t0 = time.perf_counter()
        trainer.train_step(data, targets)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    for _ in range(REPS):
        trainer.model.train()
        trainer.optimizer.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = trainer._compute_loss(trainer._preds(data), data, targets)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.optimizer.step()
        torch.cuda.synchronize()
        split += np.array([t1 - t0, t2 - t1, time.perf_counter() - t2]) * 1e3 / REPS
    _, st = traced(lambda: trainer.train_step(data, targets), PROFILED_FORWARDS, out_dir,
                   f"{name}_step", torch)
    top = sorted(st["by_kernel"].items(), key=lambda kv: -kv[1])[:6]
    conv_ms = {k: sum(t for n, t in st["by_kernel"].items() if is_kind(n, k)) for k in KERNEL_NAMES}
    return (
        f"[10 profile {name}] host wall per step (synced, unprofiled) ms: median "
        f"{np.median(wall):.4f} q1 {np.percentile(wall, 25):.4f} q3 {np.percentile(wall, 75):.4f}; "
        f"synced split ms: forward+loss {split[0]:.4f}, backward {split[1]:.4f}, "
        f"optimizer {split[2]:.4f}; under the profiler, per step: " + device_summary(st)
        + "; kernel ms per layer L0 / L1 / L2 / L3: " + "; ".join(
            # the backward launches its kernels from the last layer down
            f"{k} " + " / ".join(f"{t:.4f}" for t in (v if k.startswith("fwd") else v[::-1]))
            for k, v in st["per_layer"].items())
        + "; conv kernels device ms/step: " + ", ".join(f"{k} {t:.4f}" for k, t in conv_ms.items())
        + "; top device kernels ms/step: " + "; ".join(f"{n[:60]} {t:.4f}" for n, t in top)
        + f"; trace and tables in {out_dir}"
    )


L2_FLUSH_BYTES = 2**27  # written before a cold call: more than the H100's 50 MB L2
FLUSH_KERNEL = "FillFunctor"  # the flush's own kernel, left out of the cold times


def profile_sums(sum_inputs, out_dir, torch):
    """Phase 10c: device ms per call and layer of K1 (item pass and partial-
    row sum), its item pass, the segment sum in both roles, and index_add_
    of the same rows, each under torch.profiler over REPS calls: warm (the
    rows in L2 from the call before, as in a loop of calls) and cold (L2
    flushed before each call, as after the kernel that wrote the rows and
    the others of the step)."""
    from matten_tpu_torch.kernels import fused_conv

    out_dir.mkdir(parents=True, exist_ok=True)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=sum_inputs[0][1].device)
    names = ("K1", "item pass", "fwd_sum", "index_add_ fwd", "dx_sum", "index_add_ dx")
    ops = {(name, temp): [] for temp in ("warm", "cold") for name in names}
    for i, (k1, partial, edges, item_node, dxe, src_long) in enumerate(sum_inputs):
        acc_f = torch.zeros(edges.n_out, partial.shape[1], device=partial.device)
        acc_d = torch.zeros(edges.n_in, dxe.shape[1], device=dxe.device)
        fns = {"K1": k1, "fwd_sum": lambda: fused_conv._launch_fwd_sum(partial, edges.item_ptr, edges.n_out),
               "index_add_ fwd": lambda: acc_f.index_add_(0, item_node, partial[:item_node.shape[0]]),
               "dx_sum": lambda: fused_conv._launch_dx_sum(dxe, edges.order, edges.n_in),
               "index_add_ dx": lambda: acc_d.index_add_(0, src_long, dxe)}
        for name, fn in fns.items():
            for temp, run in (("warm", fn), ("cold", lambda: (flush.zero_(), fn()))):
                run()
                _, st = traced(run, REPS, out_dir, f"L{i}_{name.replace(' ', '_')}_{temp}", torch)
                by_kernel = {n: t for n, t in st["by_kernel"].items() if FLUSH_KERNEL not in n}
                ops[name, temp].append(sum(by_kernel.values()))
                if name == "K1":
                    ops["item pass", temp].append(sum(
                        t for n, t in by_kernel.items() if is_kind(n, "fwd")))
    return ("[10 profile sums] device ms per call L0 / L1 / L2 / L3 (sum): " + "; ".join(
        f"{name} {temp} " + " / ".join(f"{t:.4f}" for t in v) + f" ({sum(v):.4f})"
        for (name, temp), v in ops.items()))


def max_rel(results, refs):
    """Largest max|d| / max|ref| over pairs of numpy results."""
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) / max(float(np.abs(np.asarray(b)).max()), 1e-30)
               for a, b in zip(results, refs))


def nmr_phases(dev, card, torch, check_forward, check_backward, elastic_model, elastic_structures,
               elastic_targets):
    """Phases 11-15, the per-atom NMR model at full width, and serving both
    families from a checkpoint directory. Returns the launch counts of the
    main-path runs among them (the forward (12), the train steps (13) and
    `predict` from disk (14)), and the NMR trainer and batch, for phase 10."""
    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.data.dataset import DatasetStatistics, TensorDatasetConfig
    from matten_tpu_torch.data.graph import collate_graphs, pad_spec_for
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.models import create_atomic_tensor_model
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.ops.spherical_harmonics import spherical_harmonics
    from matten_tpu_torch.predict import batch_to_device, predict
    from matten_tpu_torch.train import (CanonicalRegressionTask, CheckpointManager, Trainer,
                                        TrainerConfig, save_sidecar)

    # the NMR batch: bench.py's per-atom draw, 16 crystals, Si atoms selected
    structures, rows = draw_structures(seed=2, n_graphs=16, per_atom=True)
    graphs = graphs_of(structures, rows, NMR_TARGET, SI)
    stats = DatasetStatistics.compute(graphs, TensorDatasetConfig(**NMR_DATA), normalize_tensor_target=True)
    ds_hp = dict(allowed_species=list(SPECIES_5), average_num_neighbors=stats.average_num_neighbors)
    data_np, targets_np = collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(SPECIES_5))
    data, targets = batch_to_device(data_np, dev, targets_np)
    model = create_atomic_tensor_model(NMR_HPARAMS, ds_hp, device=dev, seed=SEED).eval()
    convs = conv_layers(model)
    n_nodes, n_edges = data[K.POSITIONS].shape[0], data[K.EDGE_INDEX].shape[1]
    src, dst = data[K.EDGE_INDEX][0].contiguous(), data[K.EDGE_INDEX][1].contiguous()
    emask = data[K.EDGE_MASK][:, None].float()
    sh = (spherical_harmonics(NMR_HPARAMS["irreps_edge_sh"], data[K.EDGE_VECTORS]) * emask).contiguous()
    edges = fused_conv.edge_plan(src, dst, n_nodes, n_nodes, with_src_order=True)
    real, sel = data[K.NODE_MASK], targets["atom_selector"]
    print(f"[NMR batch] {int(real.sum())} real nodes / N={n_nodes}, {int(data_np[K.EDGE_MASK].sum())} real "
          f"edges / E={n_edges}, {len(structures)} graphs; {int(sel.sum())} Si atoms selected ({sel.dtype}); average "
          f"neighbours {stats.average_num_neighbors:.4f}; targets {NMR_TARGET} {tuple(targets[NMR_TARGET].shape)}",
          flush=True)

    # 11. kernel parity at the 4 NMR plans
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    layer_inputs, parity = [], []
    for i, conv in enumerate(convs):
        plan = conv.uvu_plan
        x = torch.randn(n_nodes, plan.irreps_in1.dim, generator=gen, device=dev)
        w = (torch.randn(n_edges, plan.weight_numel, generator=gen, device=dev) * emask).contiguous()
        g = torch.randn(n_nodes, plan.irreps_out.dim, generator=gen, device=dev)
        layer_inputs.append((plan, x, w, g))
        parity.append(f"L{i} d1={plan.irreps_in1.dim} dw={plan.weight_numel} dout={plan.irreps_out.dim} "
                      f"paths={len(plan.instructions)}: K1 {check_forward(plan, x, w, sh, src, dst, n_nodes)[1]}; "
                      + check_backward(plan, x, w, g, sh, src, dst, n_nodes))
    print(f"[11 NMR kernel parity] max|d|/max|ref| (tol {KERNEL_TOL}), two runs bitwise equal: "
          + "; ".join(parity), flush=True)

    # 12. the NMR forward through the kernels and through the plain conv
    def fwd():
        with torch.inference_mode():
            return model(data)

    def fwd_plain():
        with fused_conv.force_plain():
            return fwd()

    reset_counts(fused_conv)
    out_k = fwd()
    launched = counts(fused_conv)
    out_p = fwd_plain()
    torch.cuda.synchronize()
    if launched != {"fwd": len(convs), "fwd_sum": len(convs), "bwd": 0, "dx_sum": 0}:
        raise AssertionError(f"NMR launches per forward {launched}, expected {len(convs)} of K1's two")
    if counts(fused_conv) != launched:
        raise AssertionError("the plain NMR forward launched a kernel")
    if tuple(out_k.shape) != (n_nodes, 6) or not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"NMR model output {tuple(out_k.shape)} not finite [N, 6]")
    rel = rel_err(out_k[real], out_p[real])
    print(f"[12 NMR forward] out {tuple(out_k.shape)}, {int(real.sum())} real rows: max|d|/max|ref| K1 vs "
          f"plain = {rel:.3e} (tol {MODEL_TOL}); launches per forward {launched}", flush=True)
    if not rel <= MODEL_TOL:
        raise AssertionError(f"NMR model through K1 disagrees with the plain path: {rel}")

    # 13. the NMR train step: gradients against force_plain, then Adam steps, counted
    task = CanonicalRegressionTask(name=NMR_TARGET, per_atom=True)
    config = TrainerConfig(lr=0.01, weight_decay=1e-5)
    trainer = Trainer(create_atomic_tensor_model(NMR_HPARAMS, ds_hp, device=dev, seed=SEED), [task], config,
                      device=dev)
    trainer_p = Trainer(copy.deepcopy(trainer.model), [task], config, device=dev)
    loss_k, grads_k = step_grads(trainer, data, targets)
    with fused_conv.force_plain():
        loss_p, grads_p = step_grads(trainer_p, data, targets)
    grad_err = sorted(((rel_err(grads_k[n], r), n) for n, r in grads_p.items()), reverse=True)
    if not grad_err[0][0] <= MODEL_TOL:
        raise AssertionError(f"NMR train-step gradients disagree with the plain path: {grad_err[0]}")
    trainer_p.model.load_state_dict(trainer.model.state_dict())
    losses = []
    for _ in range(TRAIN_STEPS):
        reset_counts(fused_conv)
        loss, metric_sums = trainer.train_step(data, targets)
        losses.append(float(loss))
        step_counts = counts(fused_conv)
        if any(v != len(convs) for v in step_counts.values()):
            raise AssertionError(f"launches in one NMR train step {step_counts}, expected {len(convs)} of each")
        launched = {k: launched[k] + v for k, v in step_counts.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"NMR train losses not finite: {losses}")
    s_err, n_err = (float(v) for v in metric_sums[NMR_TARGET])
    print(f"[13 NMR train step] loss {loss_k:.6f} through the kernels, {loss_p:.6f} plain; gradients of "
          f"{len(grad_err)} parameters, max|d|/max|ref| worst: "
          + ", ".join(f"{n} {e:.3e}" for e, n in grad_err[:3]) + f" (tol {MODEL_TOL}); {TRAIN_STEPS} Adam steps "
          f"(lr {config.lr}, weight decay {config.weight_decay}): losses {', '.join(f'{l:.6f}' for l in losses)}; "
          f"last MAE {s_err / n_err:.6f} over {n_err:g} values (Si rows only); {len(convs)} launches of each "
          "kernel per step", flush=True)

    # 14. both families served from a checkpoint directory
    elastic_stats = DatasetStatistics.compute(graphs_of(elastic_structures, elastic_targets),
                                              TensorDatasetConfig(**ELASTIC_DATA), normalize_tensor_target=True)
    families = (
        ("elasticity", elastic_model, {"model": elastic_model.state_dict()}, HPARAMS, ELASTIC_DATA,
         DATASET_HPARAMS, elastic_stats, elastic_structures),
        ("NMR", trainer.model, trainer.state_dict(), NMR_HPARAMS, NMR_DATA, ds_hp, stats, structures),
    )
    served = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, fam_model, state, hp, data_hp, fam_ds, fam_stats, fam_structures in families:
            ckpt = Path(tmp) / name
            save_sidecar(ckpt, {"model": hp, "data": data_hp, "dataset_hparams": fam_ds,
                                "normalize_tensor_target": True}, fam_stats.to_arrays())
            manager = CheckpointManager(ckpt)
            manager.save(0, state, {"val/score": 1.0})
            manager.save_last(state)
            batch = fam_structures + [si_structure()]
            reset_counts(fused_conv)
            results = predict(batch, ckpt)
            torch.cuda.synchronize()
            c = counts(fused_conv)
            if c["fwd"] == 0 or c["fwd_sum"] == 0:
                raise AssertionError(f"predict from the {name} checkpoint did not launch K1: {c}")
            launched = {k: launched[k] + v for k, v in c.items()}
            refs = predict(batch, fam_model, fam_stats.target_normalizer)
            for s, r in zip(batch, results):
                shape = (len(s), 3, 3) if name == "NMR" else (3, 3, 3, 3)
                if r is None or r.shape != shape or not np.isfinite(r).all():
                    raise AssertionError(f"predict from the {name} checkpoint: not a finite {shape} tensor")
                if name == "NMR" and np.abs(r - r.transpose(0, 2, 1)).max() > 1e-6 * np.abs(r).max():
                    raise AssertionError("an NMR prediction is not symmetric")
            err = max_rel(results, refs)
            served.append(f"{name} {len(batch)} structures, max|d|/max|ref| {err:.3e} against the in-memory "
                          f"predict, launches {c}")
            if not err <= 1e-6:
                raise AssertionError(f"predict from the {name} checkpoint disagrees with the in-memory one: {err}")
    print("[14 from disk] CheckpointManager + save_sidecar, then predict(structures, checkpoint_dir) on the "
          "card (tol 1e-6): " + "; ".join(served) + f"; Si NMR tensor of atom 0 diagonal "
          f"{np.diag(results[-1][0]).round(6).tolist()}", flush=True)

    # 15. timings (CUDA events, medians of interleaved runs)
    fwd_k, fwd_p = interleaved(fwd, fwd_plain, torch)

    def step_plain():
        with fused_conv.force_plain():
            trainer_p.train_step(data, targets)

    step_k, step_p = interleaved(lambda: trainer.train_step(data, targets), step_plain, torch)
    layer_ms, bounds = {"fwd": [], "bwd": []}, {"fwd": [], "bwd": []}
    for plan, x, w, g in layer_inputs:
        with torch.no_grad():
            layer_ms["fwd"].append(interleaved(
                functools.partial(fused_conv.fused_uvu_conv, plan, x, sh, w, src, dst, n_nodes, edges),
                lambda: fused_conv.uvu_conv_reference(plan, x, sh, w, src, dst, n_nodes), torch))
            layer_ms["bwd"].append(interleaved(
                lambda: fused_conv._launch_bwd_edges(plan, x, g, sh, w, edges),
                lambda: fused_conv.uvu_conv_bwd_reference(plan, x, g, sh, w, src, dst, n_nodes), torch))
        work = kernel_work(plan, n_nodes, n_nodes, n_edges, int(edges.item_ptr[-1]))
        for kind in bounds:
            bounds[kind].append(bound_ms(*work[kind]))
    print(f"[15 NMR timings] {card}: NMR batch (16 crystals), median ms, kernel vs plain: forward "
          f"{fwd_k:.4f} vs {fwd_p:.4f}; train step {step_k:.4f} vs {step_p:.4f}; per layer L0 / L1 / L2 / L3 "
          f"(fwd: K1 with its partial-row sum vs the plain version; bwd: the merged kernel vs the plain "
          "backward): " + "; ".join(
              f"{kind} " + " / ".join(f"{k:.4f} vs {p:.4f}" for k, p in layer_ms[kind]) for kind in layer_ms)
          + "; bound ms per layer: " + "; ".join(
              f"{kind} " + " / ".join(f"{b:.4f} ({by})" for b, by in bounds[kind]) for kind in bounds)
          + f"; K1 items {int(edges.item_ptr[-1])} (grid {edges.items(16)[1]})", flush=True)
    return launched, trainer, (data, targets)


# phases 16-17: the train scripts on data files at full width
CONFIGS = Path(__file__).resolve().parent / "scripts" / "configs"
FIT_TRAIN, FIT_VAL = 256, 64  # bench.py::measure_fit_epoch_throughput's 8 x 32 crystals, and a val set
FIT_EPOCHS = 3
NMR_FIT_CRYSTALS, NMR_FIT_EPOCHS = 32, 2
# an evaluation's loss, MAE and score through the kernels vs plain: means over
# whole splits of KERNEL_TOL-sized differences
FIT_EVAL_TOL = 1e-5
EPOCH_REPS = 3  # interleaved epochs, graphed and eager


def symmetric(t):
    """The symmetric part of a rank-2 or rank-4 Cartesian tensor (ij=ji, or ijkl=jikl=klij)."""
    if t.ndim == 2:
        return (t + t.T) / 2
    t = (t + t.transpose(1, 0, 2, 3)) / 2
    t = (t + t.transpose(0, 1, 3, 2)) / 2
    return (t + t.transpose(2, 3, 0, 1)) / 2


def fit_rows(seed, n, per_atom=False):
    """Dataset rows as pandas writes them in its "records" layout: crystals
    drawn as bench.py::measure_fit_epoch_throughput draws them (4-12 atoms
    over SPECIES_5), each with a symmetric Cartesian `elastic_tensor_full`,
    or (per_atom) with its first atom Si, an `atom_selector` marking the Si
    atoms and a symmetric 3x3 `nmr_tensor` for each of them."""
    from matten_tpu_torch.data.structure import Structure

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = int(rng.integers(4, 13))
        lattice = np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1
        frac, z = rng.uniform(0, 1, size=(k, 3)), rng.choice(SPECIES_5, size=k)
        if per_atom:
            z[0] = SI
        s = Structure(lattice=lattice, frac_coords=frac, atomic_numbers=z)
        if per_atom:
            sel = z == SI
            rows.append({"structure": s.to_dict(), "atom_selector": sel.tolist(), NMR_TARGET: [
                (symmetric(rng.normal(size=(3, 3))) * 20.0 + np.eye(3) * 400.0).tolist() for _ in range(sel.sum())]})
        else:
            rows.append({"structure": s.to_dict(), TARGET: (symmetric(rng.normal(size=(3, 3, 3, 3))) * 50.0).tolist()})
    return rows


def write_records(path, rows):
    with open(path, "w") as f:
        json.dump(rows, f)


def run_script(script, config, fused_conv, torch):
    """One call of a train script's `main(config)` on the card, counted:
    (test metrics, the Trainer it made, seconds from the call to `fit`
    (data module setup, model, sidecars), launches)."""
    from matten_tpu_torch.scripts import _common

    made = []

    class Recorded(_common.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def fit(self, datamodule, *args, **kwargs):
            self.fit_called, self.datamodule = time.perf_counter(), datamodule
            return super().fit(datamodule, *args, **kwargs)

    plain = _common.Trainer
    _common.Trainer = Recorded
    try:
        reset_counts(fused_conv)
        t0 = time.perf_counter()
        metrics = script.main(config)
        torch.cuda.synchronize()
        launched = counts(fused_conv)
    finally:
        _common.Trainer = plain
    return metrics, made[0], made[0].fit_called - t0, launched


def fit_expected(convs, epochs, n_train, n_val, n_test, batch):
    """Launch counts of a fit of `epochs` epochs and a test: K1's two
    kernels once per conv layer in every train, val and test forward, the
    backward kernels in every train step."""
    steps = epochs * math.ceil(n_train / batch)
    fwd = convs * (steps + epochs * math.ceil(n_val / batch) + math.ceil(n_test / batch))
    return {"fwd": fwd, "fwd_sum": fwd, "bwd": convs * steps, "dx_sum": convs * steps}


def twin(trainer, torch):
    """A trainer of its own over a deep copy of `trainer`'s model, on its
    device and mesh, with its `scan_steps`, without checkpoints."""
    from matten_tpu_torch.train import Trainer, TrainerConfig

    return Trainer(copy.deepcopy(trainer.model), trainer.tasks, TrainerConfig(scan_steps=trainer.config.scan_steps),
                   device=trainer.device, mesh=trainer.mesh)


def eager(trainer):
    """`trainer` with every step run eagerly: its step graphs dropped, as
    on the CPU (the same capturable Adam)."""
    trainer._graphs = None
    return trainer


def fit_against_plain(label, trainer, convs, fused_conv, torch):
    """The kernels against their plain versions at a fit path's own batches:
    `_run_eval` of the trained model over each split's batches against a
    copy under `force_plain()` (K1 launched once per conv layer and batch in
    the first, no kernel in the second), and one train step's gradients on
    the first train batch of each pad shape. Returns (worst eval metric error, its
    name; worst gradient error, its parameter; the pad shapes; the first
    batch of each, on the device).

    With a mesh every rank runs it at once, on its blocks: the metrics are
    the whole batches', K1 runs once per conv layer and batch (Sg times
    under node_ring), and the gradients are compared after their sum over
    the ranks (the step's gradients)."""
    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.parallel import shard_batch
    from matten_tpu_torch.predict import batch_to_device

    dm = trainer.datamodule
    mesh = trainer.mesh
    groups = mesh.n_graph if mesh is not None and mesh.mode == "node_ring" else 1
    plain = twin(trainer, torch)
    eval_err = []
    for split in ("train", "val", "test"):
        batches = list(getattr(dm, f"{split}_dataloader")())
        before = counts(fused_conv)
        k = trainer._run_eval(batches)
        mid = counts(fused_conv)
        with fused_conv.force_plain():
            p = plain._run_eval(batches)
        after = counts(fused_conv)
        # K1 ran once per conv layer and batch in the first pass, no kernel in the second
        if mid["fwd"] - before["fwd"] != convs * groups * len(batches) or after != mid:
            raise AssertionError(f"{label}: {split} evaluation launches {before} -> {mid} -> {after}")
        eval_err += [(abs(k[m] - p[m]) / max(abs(p[m]), 1e-30), f"{split}/{m}") for m in p]
    eval_err.sort(reverse=True)
    if not eval_err[0][0] <= FIT_EVAL_TOL:
        raise AssertionError(f"{label}: evaluation through the kernels disagrees with the plain path: "
                             f"{eval_err[:3]}")

    firsts = {}
    for data, targets in dm.train_dataloader():
        # (nodes, edges) of a sub-batch, or of a rank's block of one
        firsts.setdefault((data[K.NODE_MASK].shape[-1], data[K.EDGE_MASK].shape[-1]), (data, targets))
    kernel = twin(trainer, torch)
    grad_err, on_device = [], []
    for data, targets in firsts.values():
        plain.model.load_state_dict(kernel.model.state_dict())
        if mesh is None:
            data, targets = batch_to_device(data, trainer.device, targets)
        else:
            data, targets = shard_batch(mesh, data, targets, trainer.device,
                                        [t.name for t in trainer.tasks if t.per_atom])
        on_device.append(data)
        _, grads_k = step_grads(kernel, data, targets)
        with fused_conv.force_plain():
            _, grads_p = step_grads(plain, data, targets)
        grad_err += [(rel_err(grads_k[n], r), n) for n, r in grads_p.items()]
    grad_err.sort(reverse=True)
    if not grad_err[0][0] <= MODEL_TOL:
        raise AssertionError(f"{label}: train-step gradients disagree with the plain path at the fit "
                             f"batches: {grad_err[:3]}")
    return eval_err[0], grad_err[0], sorted(firsts), on_device


def epoch_times(trainer, torch):
    """Seconds of one train epoch of copies of the trained model, graphed
    and eager, both fed by the trainer's group copies (`scan_steps`
    batches of one shape stacked, one pinned non-blocking copy per field):
    EPOCH_REPS of each after two warm-up epochs each (the graphed one runs
    the first sight of each batch shape eagerly and captures the second),
    interleaved; each epoch ends with its one loss readback, as `fit`'s
    does."""
    loader = trainer.datamodule.train_dataloader()
    modes = {"graphed": twin(trainer, torch), "eager": eager(twin(trainer, torch))}
    times = {m: [] for m in modes}
    for rep in range(EPOCH_REPS + 2):
        for m, t in modes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [t.train_step(data, targets)[0]
                      for group in t._groups(loader) for _, (data, targets) in t._device_group(group)]
            if not math.isfinite(torch.stack(losses).mean().item()):
                raise AssertionError(f"a {m} epoch gave a loss that is not finite")
            if rep >= 2:
                times[m].append(time.perf_counter() - t0)
    return times


def fit_phase(label, script, config, rows, n_train, n_val, n_test, epochs, fused_conv, torch, card):
    """Phases 16 and 17: a train script's `main` on the card from data
    files, its launches, its checkpoint directory, `predict` from it against
    the in-memory model, then a resume that adds one epoch. Returns the
    launches of the runs and of `predict` from disk."""
    from matten_tpu_torch.data.structure import Structure
    from matten_tpu_torch.predict import predict

    convs = config["model"]["num_layers"] + 1
    batch = config["data"]["loader_kwargs"]["batch_size"]
    ckpt = Path(config["trainer"]["checkpoint_dir"])
    metrics, trainer, setup_s, launched = run_script(script, config, fused_conv, torch)
    if trainer._graphs is None or trainer.config.scan_steps != config["trainer"]["scan_steps"]:
        raise AssertionError(f"{label}: the fit's steps are not graphed at scan_steps "
                             f"{config['trainer']['scan_steps']}: {trainer.config}")
    expect = fit_expected(convs, epochs, n_train, n_val, n_test, batch)
    if launched != expect:
        raise AssertionError(f"{label}: launches {launched}, expected {expect}")
    history = trainer.history
    if [h["epoch"] for h in history] != list(range(epochs)):
        raise AssertionError(f"{label}: epochs {[h['epoch'] for h in history]}")
    values = [h[k] for h in history for k in ("train/loss", "val/loss", "val/score")] + list(metrics.values())
    if not all(np.isfinite(values)):
        raise AssertionError(f"{label}: history or test metrics not finite: {history} {metrics}")
    files = {p.name for p in ckpt.iterdir()}
    if not {"hparams.json", "dataset_statistics.npz", "index.json", "last", "loop_state.json"} <= files:
        raise AssertionError(f"{label}: checkpoint directory holds {sorted(files)}")

    (e_err, e_name), (g_err, g_name), shapes, _ = fit_against_plain(label, trainer, convs, fused_conv, torch)
    epoch_modes = epoch_times(trainer, torch)

    # the host's share of an epoch: the train loader alone (shuffle and collation)
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in trainer.datamodule.train_dataloader())
    collate_s = time.perf_counter() - t0

    # predict from the directory on the card against the restored best model in memory
    per_atom = trainer.tasks[0].per_atom
    structures = [Structure.from_dict(r["structure"]) for r in rows[:16]] + [si_structure()]
    reset_counts(fused_conv)
    disk = predict(structures, ckpt)
    torch.cuda.synchronize()
    served = counts(fused_conv)
    if served["fwd"] == 0 or served["fwd_sum"] == 0:
        raise AssertionError(f"{label}: predict from the directory did not launch K1: {served}")
    mem = predict(structures, trainer.model, trainer.tasks[0].normalizer)
    for s, r in zip(structures, disk):
        shape = (len(s), 3, 3) if per_atom else (3, 3, 3, 3)
        if r is None or r.shape != shape or not np.isfinite(r).all():
            raise AssertionError(f"{label}: predict from the directory gave no finite {shape} tensor")
        if per_atom and np.abs(r - r.transpose(0, 2, 1)).max() > 1e-6 * np.abs(r).max():
            raise AssertionError(f"{label}: an NMR prediction from the directory is not symmetric")
    err = max_rel(disk, mem)
    if not err <= 1e-6:
        raise AssertionError(f"{label}: predict from the directory disagrees with the in-memory model: {err}")

    # resume from `last` with one more epoch
    config = dict(config, restore=True, trainer=dict(config["trainer"], max_epochs=epochs + 1))
    metrics2, trainer2, setup2_s, launched2 = run_script(script, config, fused_conv, torch)
    expect2 = fit_expected(convs, 1, n_train, n_val, n_test, batch)
    if [h["epoch"] for h in trainer2.history] != [epochs] or launched2 != expect2:
        raise AssertionError(f"{label}: the resume ran epochs {[h['epoch'] for h in trainer2.history]} "
                             f"with launches {launched2}; expected [{epochs}] and {expect2}")
    if not all(np.isfinite(list(metrics2.values()))):
        raise AssertionError(f"{label}: test metrics after the resume not finite: {metrics2}")
    resumed = trainer2.history[0]
    print(f"[{label}] {card}: {script.__name__.rsplit('.', 1)[-1]}.main on the card, {n_train} train / "
          f"{n_val} val / {n_test} test crystals, batch {batch}, {epochs} epochs then a resume with "
          f"`restore: true` adding epoch {epochs}: epoch times after the first (s) "
          + ", ".join(f"{h['epoch_time']:.4f}" for h in history[1:])
          + "; train edges/s " + ", ".join(f"{h['train/edges_per_s']:.1f}" for h in history[1:])
          + f" (epoch 0: {history[0]['epoch_time']:.4f} s, {history[0]['train/edges_per_s']:.1f}; the resumed "
          f"epoch, the first of the resumed run: {resumed['epoch_time']:.4f} s, "
          f"{resumed['train/edges_per_s']:.1f})"
          + f"; the train loader alone (shuffle, collation of {n_batches} batches) {collate_s:.4f} s"
          + f"; setup to fit (data module, model, sidecars) {setup_s:.4f} s, on the resume {setup2_s:.4f} s "
          f"(graph cache reuse: {config['data'].get('reuse')}); val/score per epoch "
          + ", ".join(f"{h['val/score']:.6g}" for h in history + trainer2.history)
          + f"; test {json.dumps(metrics)}; launches {launched} then {launched2} (expected, per conv layer: "
          f"train steps, val and test batches); the directory holds {sorted(files)}; predict of "
          f"{len(structures)} structures from it against the in-memory best model: max|d|/max|ref| "
          f"{err:.3e} (tol 1e-6), launches {served}; against the plain versions at the fit batches: "
          f"evaluation of the best model over train, val and test worst {e_name} {e_err:.3e} relative "
          f"(tol {FIT_EVAL_TOL}), one train step's gradients on the first batch of each of the "
          f"{len(shapes)} pad shapes (nodes, edges) {shapes} worst {g_name} {g_err:.3e} (tol {MODEL_TOL}); "
          f"scan_steps {trainer.config.scan_steps}, {len(trainer._graphs.graphs)} step graphs, their pools "
          f"{trainer._graphs.pool_bytes() / 2**20:.1f} MiB; train epoch (s, interleaved, two warm-up epochs each "
          "before): " + "; ".join(f"{m} " + ", ".join(f"{x:.4f}" for x in v) for m, v in epoch_modes.items()),
          flush=True)
    return {k: launched[k] + launched2[k] + served[k] for k in COUNTERS}


def fit_phases(fused_conv, torch, card):
    """Phases 16 (elasticity: materials_tensor_production.yaml, 256 + 64
    crystals) and 17 (NMR: atomic_tensor.yaml, 32 crystals), the train
    scripts from data files at full width. Returns their launches."""
    from matten_tpu_torch.scripts import train_atomic_tensor, train_materials_tensor
    from matten_tpu_torch.utils.config_yaml import load_config

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train, val = fit_rows(4, FIT_TRAIN), fit_rows(5, FIT_VAL)
        write_records(tmp / "train.json", train)
        write_records(tmp / "val.json", val)
        config = load_config(CONFIGS / "materials_tensor_production.yaml")
        config["data"].update(root=str(tmp), trainset_filename="train.json", valset_filename="val.json",
                              testset_filename="val.json")
        config["trainer"].update(max_epochs=FIT_EPOCHS, checkpoint_dir=str(tmp / "elastic_ckpt"))
        config["restore"] = False
        elastic = fit_phase("16 fit, elasticity", train_materials_tensor, config, val, FIT_TRAIN, FIT_VAL,
                            FIT_VAL, FIT_EPOCHS, fused_conv, torch, card)

        rows = fit_rows(6, NMR_FIT_CRYSTALS, per_atom=True)
        write_records(tmp / "nmr.json", rows)
        config = load_config(CONFIGS / "atomic_tensor.yaml")
        config["data"].update(root=str(tmp), trainset_filename="nmr.json", valset_filename="nmr.json",
                              testset_filename="nmr.json")
        # scan_steps as the production yaml sets it (atomic_tensor.yaml leaves the default, 1)
        config["trainer"].update(max_epochs=NMR_FIT_EPOCHS, checkpoint_dir=str(tmp / "nmr_ckpt"), scan_steps=8)
        nmr = fit_phase("17 fit, NMR", train_atomic_tensor, config, rows, NMR_FIT_CRYSTALS, NMR_FIT_CRYSTALS,
                        NMR_FIT_CRYSTALS, NMR_FIT_EPOCHS, fused_conv, torch, card)
    return {k: elastic[k] + nmr[k] for k in COUNTERS}


# phases 18-19: the variants configuration, materials_tensor_production.yaml
# with every model and data option the port refused before PR 7
SCALAR = "k_voigt"
VARIANT_MODEL = dict(normalization="instance", nonlinearity_type="norm", radial_basis_type="gaussian",
                     reduce="max", use_atom_feats=True, use_global_feats=True,
                     task_weights={TARGET: 1.0, SCALAR: 0.5})
SOURCE_WEIGHTS = {"dft": 1.0, "experiment": 2.0}  # the weight column's values -> the crystal's loss weight
VARIANT_DATA = dict(atom_featurizer="site_feat", global_featurizer="density", normalize_atom_features=True,
                    normalize_global_features=True, scalar_target_names=[SCALAR], log_scalar_targets=[True],
                    normalize_scalar_targets=[True], tensor_target_scale=0.1,
                    tensor_target_weight={"source": SOURCE_WEIGHTS})


def variant_hparams():
    """The model hparams and dataset hand-off of the variants configuration
    at the production widths, as the materials script builds them (one
    feature column each: the hand-off's sizes 1 and 1)."""
    hp = {k: v for k, v in VARIANT_MODEL.items() if k != "task_weights"}
    return (dict(HPARAMS, **hp, tensor_target_name=TARGET, scalar_target_names=[SCALAR]),
            dict(DATASET_HPARAMS, atom_feats_size=1, global_feats_size=1))


def variant_tasks():
    from matten_tpu_torch.train import CanonicalRegressionTask

    return [CanonicalRegressionTask(name=n, loss_weight=w, metric_weight=w)
            for n, w in VARIANT_MODEL["task_weights"].items()]


def with_variant_columns(rows, seed):
    """The fit rows with the variants configuration's columns, drawn from
    `np.random.default_rng(seed)`: a positive `k_voigt`, one per-atom
    feature (`site_feat`), one per-crystal feature (`density`) and the
    string weight column (`source`)."""
    rng = np.random.default_rng(seed)
    for row in rows:
        n = len(row["structure"]["sites"])
        row.update(k_voigt=float(rng.uniform(50.0, 300.0)), site_feat=rng.normal(size=n).tolist(),
                   density=float(rng.uniform(2.0, 8.0)), source=str(rng.choice(sorted(SOURCE_WEIGHTS))))
    return rows


def variant_phases(dev, card, torch, check_forward, check_backward, production, structures, targets, sh, src,
                   dst):
    """Phase 18: the variants model at full width on the flagship crystals
    (with seeded feature columns, `k_voigt` and target weights): its 4 conv
    plans against the production ones, the kernels at them against their
    plain versions, the forward and one step's gradients against
    `force_plain()`, a few train steps, per-layer timings. Returns the
    launches of its main-path runs, and its trainer and batch."""
    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.data.graph import CrystalGraph, collate_graphs, pad_spec_for
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.predict import batch_to_device
    from matten_tpu_torch.train import Trainer, TrainerConfig

    hp, ds_hp = variant_hparams()
    rng = np.random.default_rng(SEED + 18)
    graphs = []
    for s, y in zip(structures, targets):
        x = {"atom_feats": rng.normal(size=(len(s), 1)), "global_feats": rng.normal(size=(1, 1)),
             "target_weight": np.asarray([[SOURCE_WEIGHTS[str(rng.choice(sorted(SOURCE_WEIGHTS)))]]])}
        graphs.append(CrystalGraph.from_structure(s, r_cut=5.0, x=x, y={TARGET: y, SCALAR: rng.normal(size=(1, 1))}))
    data_np, targets_np = collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(SPECIES_5))
    data, targets_d = batch_to_device(data_np, dev, targets_np)
    real = data[K.GRAPH_MASK]
    n_nodes, n_edges = data[K.POSITIONS].shape[0], data[K.EDGE_INDEX].shape[1]
    model = create_scalar_tensor_model(hp, ds_hp, device=dev, seed=SEED).eval()
    convs = conv_layers(model)

    def shape(conv):
        p = conv.uvu_plan
        return (p.irreps_in1.dim, p.weight_numel, p.irreps_out.dim, len(p.instructions))

    plans = [shape(c) for c in convs]
    differ = [i for i, (c, q) in enumerate(zip(convs, conv_layers(production))) if shape(c) != shape(q)]
    print(f"[18 variants batch] {int(real.sum())} real graphs / G={real.shape[0]} ({real.shape[0] - int(real.sum())} "
          f"all-padding), N={n_nodes}, E={n_edges}; node features {convs[0].irreps_in[K.NODE_FEATURES]} (an "
          f"embedding of {hp['species_embedding_dim']}, 1 atom and 1 global feature); conv plans d1/dw/dout/paths "
          + ", ".join(f"L{i} {'/'.join(map(str, q))}" for i, q in enumerate(plans))
          + f"; differing from production at L{differ}", flush=True)

    # the kernels at the variant plans
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    emask = data[K.EDGE_MASK][:, None].float()
    layer_inputs, parity = [], []
    for i, conv in enumerate(convs):
        plan = conv.uvu_plan
        x = torch.randn(n_nodes, plan.irreps_in1.dim, generator=gen, device=dev)
        w = (torch.randn(n_edges, plan.weight_numel, generator=gen, device=dev) * emask).contiguous()
        g = torch.randn(n_nodes, plan.irreps_out.dim, generator=gen, device=dev)
        layer_inputs.append((plan, x, w, g))
        parity.append(f"L{i}: K1 {check_forward(plan, x, w, sh, src, dst, n_nodes)[1]}; "
                      + check_backward(plan, x, w, g, sh, src, dst, n_nodes))

    # the forward through the kernels and under force_plain
    def fwd():
        with torch.inference_mode():
            return model(data)

    reset_counts(fused_conv)
    out_k = fwd()
    launched = counts(fused_conv)
    with fused_conv.force_plain():
        out_p = fwd()
    torch.cuda.synchronize()
    if launched != {"fwd": len(convs), "fwd_sum": len(convs), "bwd": 0, "dx_sum": 0}:
        raise AssertionError(f"variants launches per forward {launched}, expected {len(convs)} of K1's two")
    if counts(fused_conv) != launched:
        raise AssertionError("the plain variants forward launched a kernel")
    if sorted(out_k) != sorted([TARGET, SCALAR]) or tuple(out_k[TARGET].shape) != (real.shape[0], 21) \
            or tuple(out_k[SCALAR].shape) != (real.shape[0], 1):
        raise AssertionError(f"variants outputs {({k: tuple(v.shape) for k, v in out_k.items()})}")
    fwd_err = {k: rel_err(out_k[k][real], out_p[k][real]) for k in out_k}
    if not all(torch.isfinite(v).all() for v in out_k.values()) or not max(fwd_err.values()) <= MODEL_TOL:
        raise AssertionError(f"the variants forward through the kernels disagrees with plain: {fwd_err}")

    # one step's gradients against a deep copy under force_plain, then Adam steps, counted
    config = TrainerConfig(lr=0.01, weight_decay=1e-5)
    trainer = Trainer(create_scalar_tensor_model(hp, ds_hp, device=dev, seed=SEED), variant_tasks(), config,
                      device=dev)
    trainer_p = Trainer(copy.deepcopy(trainer.model), variant_tasks(), config, device=dev)
    loss_k, grads_k = step_grads(trainer, data, targets_d)
    with fused_conv.force_plain():
        loss_p, grads_p = step_grads(trainer_p, data, targets_d)
    if not all(bool(torch.isfinite(g).all()) for g in grads_k.values()):
        raise AssertionError("a variants gradient is not finite (instance norm over the all-padding graphs?)")
    grad_err = sorted(((rel_err(grads_k[n], r), n) for n, r in grads_p.items()), reverse=True)
    if not grad_err[0][0] <= MODEL_TOL:
        raise AssertionError(f"variants train-step gradients disagree with the plain path: {grad_err[:3]}")
    trainer_p.model.load_state_dict(trainer.model.state_dict())
    losses = []
    for _ in range(TRAIN_STEPS):
        reset_counts(fused_conv)
        loss, metric_sums = trainer.train_step(data, targets_d)
        losses.append(float(loss))
        step_counts = counts(fused_conv)
        if any(v != len(convs) for v in step_counts.values()):
            raise AssertionError(f"launches in one variants train step {step_counts}, expected {len(convs)} of each")
        launched = {k: launched[k] + v for k, v in step_counts.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"variants train losses not finite: {losses}")
    maes = {n: float(s) / float(c) for n, (s, c) in metric_sums.items()}

    # per-layer timings, kernel against plain, beside the bound
    layer_ms, bounds = {"fwd": [], "bwd": []}, {"fwd": [], "bwd": []}
    edges = fused_conv.edge_plan(src, dst, n_nodes, n_nodes)
    for plan, x, w, g in layer_inputs:
        with torch.no_grad():
            layer_ms["fwd"].append(interleaved(
                functools.partial(fused_conv.fused_uvu_conv, plan, x, sh, w, src, dst, n_nodes, edges),
                lambda: fused_conv.uvu_conv_reference(plan, x, sh, w, src, dst, n_nodes), torch))
            layer_ms["bwd"].append(interleaved(
                lambda: fused_conv._launch_bwd_edges(plan, x, g, sh, w, edges),
                lambda: fused_conv.uvu_conv_bwd_reference(plan, x, g, sh, w, src, dst, n_nodes), torch))
        work = kernel_work(plan, n_nodes, n_nodes, n_edges, int(edges.item_ptr[-1]))
        for kind in bounds:
            bounds[kind].append(bound_ms(*work[kind]))
    print(f"[18 variants kernels and gradients] {card}: max|d|/max|ref| (tol {KERNEL_TOL}), two runs bitwise "
          "equal: " + "; ".join(parity)
          + f"; forward through the kernels vs plain (tol {MODEL_TOL}): "
          + ", ".join(f"{k} {e:.3e}" for k, e in fwd_err.items())
          + f"; one step's gradients (loss {loss_k:.6f} vs {loss_p:.6f} plain, {len(grad_err)} parameters, all "
          "finite) worst: " + ", ".join(f"{n} {e:.3e}" for e, n in grad_err[:3]) + f" (tol {MODEL_TOL}); "
          f"{TRAIN_STEPS} Adam steps: losses {', '.join(f'{l:.6f}' for l in losses)}, last MAE "
          + ", ".join(f"{n} {m:.6f}" for n, m in maes.items())
          + f"; launches {launched} ({len(convs)} of K1's two per forward, {len(convs)} of each per step); "
          "median ms per layer "
          "L0 / L1 / L2 / L3, kernel vs plain: " + "; ".join(
              f"{kind} " + " / ".join(f"{k:.4f} vs {p:.4f}" for k, p in layer_ms[kind]) for kind in layer_ms)
          + "; bound ms per layer: " + "; ".join(
              f"{kind} " + " / ".join(f"{b:.4f} ({by})" for b, by in bounds[kind]) for kind in bounds)
          + f"; K1 items {int(edges.item_ptr[-1])} (grid {edges.items(16)[1]})", flush=True)
    return launched, trainer, (data, targets_d)


def variants_fit_phase(fused_conv, torch, card):
    """Phase 19: `train_materials_tensor.main` on the card with the variants
    configuration, from data files with its columns; exact launches, both
    tasks' MAE in a finite history, the checkpoint directory (`predict`
    from structures refuses a model that reads feature columns, as the JAX
    `predict` fails on it; the directory's model, `load_pretrained`, on the
    test batches equal to the in-memory best model), and the kernels
    against their plain versions at the fit's batches. Returns the launches."""
    from matten_tpu_torch.data.structure import Structure
    from matten_tpu_torch.predict import batch_to_device, load_pretrained, predict
    from matten_tpu_torch.scripts import train_materials_tensor
    from matten_tpu_torch.utils.config_yaml import load_config

    label = "19 fit, variants"
    convs = HPARAMS["num_layers"] + 1
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train = with_variant_columns(fit_rows(4, FIT_TRAIN), 40)
        val = with_variant_columns(fit_rows(5, FIT_VAL), 50)
        write_records(tmp / "train.json", train)
        write_records(tmp / "val.json", val)
        config = load_config(CONFIGS / "materials_tensor_production.yaml")
        config["model"].update(VARIANT_MODEL)
        config["data"].update(VARIANT_DATA, root=str(tmp), trainset_filename="train.json",
                              valset_filename="val.json", testset_filename="val.json")
        config["trainer"].update(max_epochs=FIT_EPOCHS, checkpoint_dir=str(tmp / "variants_ckpt"))
        config["restore"] = False
        ckpt = Path(config["trainer"]["checkpoint_dir"])
        batch = config["data"]["loader_kwargs"]["batch_size"]
        metrics, trainer, setup_s, launched = run_script(train_materials_tensor, config, fused_conv, torch)
        expect = fit_expected(convs, FIT_EPOCHS, FIT_TRAIN, FIT_VAL, FIT_VAL, batch)
        if launched != expect:
            raise AssertionError(f"{label}: launches {launched}, expected {expect}")
        history = trainer.history
        maes = [f"val/mae/{TARGET}", f"val/mae/{SCALAR}"]
        if [h["epoch"] for h in history] != list(range(FIT_EPOCHS)) or not all(m in h for h in history for m in maes):
            raise AssertionError(f"{label}: history {history}")
        values = [h[k] for h in history for k in ("train/loss", "val/loss", "val/score", *maes)]
        if not all(np.isfinite(values + list(metrics.values()))) or f"mae/{SCALAR}" not in metrics:
            raise AssertionError(f"{label}: history or test metrics not finite or incomplete: {history} {metrics}")
        weights = [g.x["target_weight"][0, 0] for g in trainer.datamodule.graphs["train"]]
        (e_err, e_name), (g_err, g_name), shapes, _ = fit_against_plain(label, trainer, convs, fused_conv, torch)

        # the directory: predict from structures refuses the feature model;
        # its model on the test batches equals the in-memory best model
        structures = [Structure.from_dict(r["structure"]) for r in val[:4]]
        try:
            predict(structures, ckpt)
        except ValueError as e:
            if "feature columns" not in str(e):
                raise
        else:
            raise AssertionError(f"{label}: predict(structures, directory) served a model that reads features")
        disk, _, _, _ = load_pretrained(ckpt)
        reset_counts(fused_conv)
        err = 0.0
        with torch.inference_mode():
            for d, _ in trainer.datamodule.test_dataloader():
                d = batch_to_device(d, trainer.device)
                a, b = disk(d), trainer.model.eval()(d)
                err = max([err] + [rel_err(a[k], b[k]) for k in b])
        torch.cuda.synchronize()
        served = counts(fused_conv)
        if served["fwd"] == 0 or not err <= 1e-6:
            raise AssertionError(f"{label}: the directory's model against the in-memory one: {err}, launches {served}")
    print(f"[{label}] {card}: train_materials_tensor.main on the card with materials_tensor_production.yaml and "
          f"the overrides model {json.dumps(VARIANT_MODEL)}, data {json.dumps(VARIANT_DATA)}; {FIT_TRAIN} train / "
          f"{FIT_VAL} val / {FIT_VAL} test crystals, batch {batch}, {FIT_EPOCHS} epochs (train weights "
          f"{sorted(set(map(float, weights)))}): epoch times after the first (s) "
          + ", ".join(f"{h['epoch_time']:.4f}" for h in history[1:])
          + "; train edges/s " + ", ".join(f"{h['train/edges_per_s']:.1f}" for h in history[1:])
          + f" (epoch 0: {history[0]['epoch_time']:.4f} s); setup to fit {setup_s:.4f} s; val MAE per epoch "
          + "; ".join(", ".join(f"{m.split('/')[-1]} {h[m]:.6g}" for m in maes) for h in history)
          + f"; test {json.dumps(metrics)}; launches {launched} (expected); predict(structures, directory) refuses "
          f"the feature model; the directory's model on the test batches against the in-memory best model: "
          f"max|d|/max|ref| {err:.3e} (tol 1e-6), launches {served}; against the plain versions at the fit batches: "
          f"evaluation worst {e_name} {e_err:.3e} (tol {FIT_EVAL_TOL}), gradients on the first batch of each of "
          f"the {len(shapes)} pad shapes {shapes} worst {g_name} {g_err:.3e} (tol {MODEL_TOL})", flush=True)
    return {k: launched[k] + served[k] for k in COUNTERS}



# phases 20-22: data and graph parallelism, 2 ranks on the one card (gloo);
# `--cards N`: the same on N cards, one rank per card (nccl)
MESH_EPOCHS = 2
MESH_TIMEOUT_S = 600
MESH_REPS = 5  # timed train steps, and timed kernel calls per layer, on each rank
MESH_PROFILED_STEPS = 2  # profiled train steps per rank (phase 21's flagship graph modes; every case of --cards)
# what a rank's seconds per case were spent on (`mesh_rank`)
MESH_PHASES = ("mesh and model", "counted step", "kernel checks", "timed steps", "profiled steps")
# torch threads of each rank: the host's cores are shared by this process
# and both ranks
MESH_THREADS = 2


def shard_edge_groups(data, mode, n_graph, torch):
    """The conv kernels' edge groups on a rank's block: (src, dst, n_in,
    n_out, rows) with src as the kernels index it: every edge with nodes
    replicated (edge) or src into the gathered nodes (node); per ring
    group g, src - g * c (node_ring)."""
    from matten_tpu_torch.data import keys as K

    src, dst = (t.contiguous() for t in data[K.EDGE_INDEX])
    n = data[K.POSITIONS].shape[0]
    e = src.shape[0]
    if mode == "edge":
        return [(src, dst, n, n, slice(0, e))]
    if mode == "node":
        return [(src, dst, n_graph * n, n, slice(0, e))]
    cap2 = e // n_graph
    return [((src[g * cap2:(g + 1) * cap2] - g * n).contiguous(), dst[g * cap2:(g + 1) * cap2].contiguous(),
             n, n, slice(g * cap2, (g + 1) * cap2)) for g in range(n_graph)]


def shard_kernels(model, hp, data, mode, n_graph, torch, timed=True, time_plain=False):
    """K1 (with its partial-row sum) and the merged backward (with the dx
    sum) against their plain versions at a rank's own plans: every conv
    layer's uvu plan on every edge group of the rank's block, seeded random
    x, w and g, the block's SH; and, `timed`, each kernel's wrapper time per
    layer (median of MESH_REPS calls by CUDA events, both ranks at once on
    the card) and bound, with `time_plain` also its plain version's (one
    call by CUDA events, after the check's). Returns (max |d| per kind,
    worst relative error, per-layer ms, per-layer plain ms, per-layer
    bounds)."""
    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.ops.spherical_harmonics import spherical_harmonics

    dev = data[K.POSITIONS].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    emask = data[K.EDGE_MASK][:, None].float()
    sh_all = (spherical_harmonics(hp["irreps_edge_sh"], data[K.EDGE_VECTORS]) * emask).contiguous()
    max_abs = {k: 0.0 for k in COUNTERS}
    worst, ms, plain_ms, bounds = 0.0, {"fwd": [], "bwd": []}, {"fwd": [], "bwd": []}, {k: [] for k in COUNTERS}

    def median_ms(fn):
        return float(np.median([cuda_ms(fn, torch) for _ in range(MESH_REPS)]))

    for conv in conv_layers(model):
        plan = conv.uvu_plan
        layer_ms, layer_plain = {"fwd": 0.0, "bwd": 0.0}, {"fwd": 0.0, "bwd": 0.0}
        layer_bound = {k: [0.0, "bytes"] for k in COUNTERS}
        for src, dst, n_in, n_out, rows in shard_edge_groups(data, mode, n_graph, torch):
            sh = sh_all[rows].contiguous()
            x = torch.randn(n_in, plan.irreps_in1.dim, generator=gen, device=dev)
            w = (torch.randn(sh.shape[0], plan.weight_numel, generator=gen, device=dev) * emask[rows]).contiguous()
            g = torch.randn(n_out, plan.irreps_out.dim, generator=gen, device=dev)
            edges = fused_conv.edge_plan(src, dst, n_in, n_out, with_src_order=True)
            with torch.no_grad():
                out = fused_conv.fused_uvu_conv(plan, x, sh, w, src, dst, n_out, edges)
                ref = fused_conv.uvu_conv_reference(plan, x, sh, w, src, dst, n_out)
                dx, dw = fused_conv.uvu_conv_bwd(plan, x, g, sh, w, src, dst, n_in, edges)
                dx_ref, dw_ref = fused_conv.uvu_conv_bwd_reference(plan, x, g, sh, w, src, dst, n_in)
                for kinds, a, b in ((("fwd", "fwd_sum"), out, ref), (("bwd",), dw, dw_ref),
                                    (("dx_sum",), dx, dx_ref)):
                    worst = max(worst, rel_err(a, b))
                    for kind in kinds:
                        max_abs[kind] = max(max_abs[kind], float((a - b).abs().max()))
                if timed:
                    layer_ms["fwd"] += median_ms(
                        lambda: fused_conv.fused_uvu_conv(plan, x, sh, w, src, dst, n_out, edges))
                    layer_ms["bwd"] += median_ms(
                        lambda: fused_conv.uvu_conv_bwd(plan, x, g, sh, w, src, dst, n_in, edges))
                if time_plain:
                    layer_plain["fwd"] += cuda_ms(
                        lambda: fused_conv.uvu_conv_reference(plan, x, sh, w, src, dst, n_out), torch)
                    layer_plain["bwd"] += cuda_ms(
                        lambda: fused_conv.uvu_conv_bwd_reference(plan, x, g, sh, w, src, dst, n_in), torch)
            for kind, (nbytes, flops) in kernel_work(plan, n_in, n_out, src.shape[0], int(edges.item_ptr[-1])).items():
                t, by = bound_ms(nbytes, flops)
                layer_bound[kind] = [layer_bound[kind][0] + t, by]
        for kind in ms:
            ms[kind].append(layer_ms[kind])
            plain_ms[kind].append(layer_plain[kind])
        for kind in bounds:
            bounds[kind].append(tuple(layer_bound[kind]))
    return max_abs, worst, ms, plain_ms, bounds


def mesh_rank(rank, world_size, job):
    """A rank of phases 20-21 and of `--cards`: for each case, its mesh,
    the model from the seed, one counted SGD `Trainer.train_step` on its
    block of the stacked batch (the main path), its gradients and
    parameters, the kernels against their plain versions at its own plans,
    then MESH_REPS steps timed by CUDA events, and with the case's
    `profile` the conv and NCCL kernels' device time per step on rank 0;
    the seconds each of these took. The rank's
    card is the launcher's: cuda:0 for ranks that share it under gloo,
    card r under nccl."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.models import create_atomic_tensor_model, create_scalar_tensor_model
    from matten_tpu_torch.parallel import make_mesh, shard_batch
    from matten_tpu_torch.parallel.collectives import stages_through_host
    from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for case in job:
        marks = [time.perf_counter()]
        mesh = make_mesh(case["n_data"], case["n_graph"], case["mode"])
        create = create_atomic_tensor_model if case["per_atom"] else create_scalar_tensor_model
        model = create(case["hparams"], case["ds"], device=dev, seed=SEED)
        task = CanonicalRegressionTask(name=case["target"], per_atom=case["per_atom"])
        trainer = Trainer(model, [task], TrainerConfig(lr=0.01, optimizer="sgd", scheduler="none"), device=dev,
                          mesh=mesh)
        data, targets = shard_batch(mesh, *case["batch"], dev, [task.name] if task.per_atom else [])
        marks.append(time.perf_counter())
        reset_counts(fused_conv)
        loss, metrics = trainer.train_step(data, targets)
        torch.cuda.synchronize()
        launched = counts(fused_conv)
        marks.append(time.perf_counter())
        res = {
            "loss": float(loss), "metric": float(metrics[task.name][0]), "launched": launched,
            "grads": {n: p.grad.cpu().numpy().copy() for n, p in trainer.model.named_parameters()},
            "params": {n: p.detach().cpu().numpy().copy() for n, p in trainer.model.named_parameters()},
            "staged": stages_through_host(data["pos"], mesh.graph),
        }
        # the profiled cases also time the plain versions (PERF.md's rows
        # of a rank's block)
        (res["max_abs"], res["kernel_rel"], res["kernel_ms"], res["plain_ms"], res["bounds"]) = shard_kernels(
            trainer.model, case["hparams"], data, case["mode"], case["n_graph"], torch, time_plain=case["profile"])
        marks.append(time.perf_counter())
        res["step_ms"] = float(np.median(
            [cuda_ms(lambda: trainer.train_step(data, targets), torch) for _ in range(MESH_REPS)]))
        marks.append(time.perf_counter())
        # device time per step of the conv kernels and of NCCL's, on rank 0
        # (the others take the same steps unprofiled: they meet in their
        # collectives)
        res["device_ms"] = res["nccl_ms"] = None
        if case["profile"] and rank == 0:
            with tempfile.TemporaryDirectory() as tmp:
                _, st = traced(lambda: trainer.train_step(data, targets), MESH_PROFILED_STEPS, Path(tmp), "step",
                               torch)
            res["device_ms"] = {k: sum(t for n, t in st["by_kernel"].items() if is_kind(n, k)) for k in KERNEL_NAMES}
            res["nccl_ms"] = sum(t for n, t in st["by_kernel"].items() if n.startswith("nccl"))
        elif case["profile"]:
            for _ in range(MESH_PROFILED_STEPS):
                trainer.train_step(data, targets)
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        res["phase_s"] = np.diff(marks).tolist()  # MESH_PHASES
        out[case["name"]] = res
    return out


def script_rank(rank, world_size, job):
    """A rank of phase 22: the materials script's `main` on a data 1 x graph
    2 node mesh, counted; then, on both ranks at once, the kernels against
    their plain versions at the fit's own blocks (`fit_against_plain`, and
    `shard_kernels` on the first block of each pad shape); rank 0 then
    serves the directory it wrote with `predict` against its in-memory best
    model."""
    import torch

    from matten_tpu_torch.data.structure import Structure
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.predict import model_from_sidecar, predict
    from matten_tpu_torch.scripts import train_materials_tensor
    from matten_tpu_torch.train import load_sidecar

    metrics, trainer, setup_s, launched = run_script(train_materials_tensor, job["config"], fused_conv, torch)
    res = {"metrics": metrics, "launched": launched, "setup_s": setup_s,
           "history": [{k: h[k] for k in ("epoch", "epoch_time", "train/edges_per_s", "val/score")}
                       for h in trainer.history],
           "served": {k: 0 for k in COUNTERS}}
    model_hp = job["config"]["model"]
    res["eval_err"], res["grad_err"], res["shapes"], blocks = fit_against_plain(
        "22 mesh fit", trainer, model_hp["num_layers"] + 1, fused_conv, torch)
    res["max_abs"], res["kernel_rel"] = {k: 0.0 for k in COUNTERS}, 0.0
    for data in blocks:
        max_abs, worst, _, _, _ = shard_kernels(trainer.model, model_hp, data, trainer.mesh.mode,
                                                trainer.mesh.n_graph, torch, timed=False)
        res["kernel_rel"] = max(res["kernel_rel"], worst)
        res["max_abs"] = {k: max(res["max_abs"][k], max_abs[k]) for k in COUNTERS}
    if rank == 0:
        ckpt = Path(job["config"]["trainer"]["checkpoint_dir"])
        structures = [Structure.from_dict(r["structure"]) for r in job["rows"]] + [si_structure()]
        reset_counts(fused_conv)
        disk = predict(structures, ckpt)
        torch.cuda.synchronize()
        res["served"] = counts(fused_conv)
        # rank 0's in-memory best model is graph-parallel: its weights in
        # the one-device model the sidecars describe
        single, _, _ = model_from_sidecar(*load_sidecar(ckpt), trainer.device)
        single.load_state_dict(trainer.model.state_dict())
        mem = predict(structures, single.eval(), trainer.tasks[0].normalizer)
        if not all(r is not None and r.shape == (3, 3, 3, 3) and np.isfinite(r).all() for r in disk):
            raise AssertionError("phase 22: predict from the directory gave no finite [3,3,3,3] tensor")
        res["predict_err"] = max_rel(disk, mem)
        res["files"] = sorted(p.name for p in ckpt.iterdir())
    return res


# (name, n_data, n_graph, mode, model) of phases 20-21's step cases; the
# models are `mesh_cases`'
GLOO_CASES = (
    ("20 dp 2x1", 2, 1, "edge", "no_bn"),
    ("20 dp ragged 2x1", 2, 1, "edge", "no_bn_ragged"),
    ("21 edge 1x2", 1, 2, "edge", "production"),
    ("21 node 1x2", 1, 2, "node", "production"),
    ("21 node_ring 1x2", 1, 2, "node_ring", "production"),
    ("21 node 1x2 NMR", 1, 2, "node", "nmr"),
)


def card_cases(n):
    """`--cards n`'s step cases: data parallel n x 1, each graph mode at
    1 x n, node at 2 x n/2 (n even and at least 4), node on the NMR batch,
    and node at 1 x n with max pooling (its pmax across the cards)."""
    cases = [(f"dp {n}x1", n, 1, "edge", "no_bn")]
    cases += [(f"{mode} 1x{n}", 1, n, mode, "production") for mode in ("edge", "node", "node_ring")]
    if n >= 4 and n % 2 == 0:
        cases.append((f"2x{n // 2} node", 2, n // 2, "node", "no_bn"))
    return cases + [(f"NMR node 1x{n}", 1, n, "node", "nmr"), (f"max pooling node 1x{n}", 1, n, "node", "max_pool")]


def mesh_cases(specs, structures, target_rows, profile_all):
    """The step cases of `specs` as rank jobs: the model's hparams
    (graph-parallel when the mesh splits graphs) and the port loader's
    stacked batch for the mesh, and under "single" the 1-rank model and
    graphs. Models: "production" (HPARAMS on the flagship batch),
    "no_bn" (without batch norm: data parallelism normalizes each shard by
    its own statistics, so only then is it the 1-rank step, as in the JAX
    tests; the graph modes keep the whole graph's statistics),
    "no_bn_ragged" (one crystal over the data axis), "max_pool" (the
    production model pooling by max) and "nmr" (the NMR model on the NMR
    batch). A case is profiled in the graph modes on the
    flagship batch, or always with `profile_all`."""
    from matten_tpu_torch.data.datamodule import BatchLoader
    from matten_tpu_torch.data.dataset import DatasetStatistics, TensorDatasetConfig
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.train.config import MeshSpec

    smap = atomic_number_map(SPECIES_5)
    graphs = graphs_of(structures, target_rows)
    nmr_structures, nmr_rows = draw_structures(seed=2, n_graphs=16, per_atom=True)
    nmr_graphs = graphs_of(nmr_structures, nmr_rows, NMR_TARGET, SI)
    nmr_stats = DatasetStatistics.compute(nmr_graphs, TensorDatasetConfig(**NMR_DATA), normalize_tensor_target=True)
    nmr_ds = dict(allowed_species=list(SPECIES_5), average_num_neighbors=nmr_stats.average_num_neighbors)
    no_bn = dict(HPARAMS, normalization=None)
    models = {"production": (HPARAMS, DATASET_HPARAMS, graphs, False),
              "no_bn": (no_bn, DATASET_HPARAMS, graphs, False),
              "no_bn_ragged": (no_bn, DATASET_HPARAMS, graphs[:1], False),
              "max_pool": (dict(HPARAMS, reduce="max"), DATASET_HPARAMS, graphs, False),
              "nmr": (NMR_HPARAMS, nmr_ds, nmr_graphs, True)}
    cases = []
    for name, n_data, n_graph, mode, model in specs:
        hp, ds, gs, per_atom = models[model]
        loader = BatchLoader(gs, batch_size=max(len(gs), n_data), species_map=smap, num_buckets=1,
                             **MeshSpec(n_data, n_graph, mode).loader_kwargs())
        parallel = dict(hp, graph_parallel_axis="graph", graph_parallel_mode=mode) if n_graph > 1 else hp
        cases.append(dict(name=name, n_data=n_data, n_graph=n_graph, mode=mode, hparams=parallel, ds=ds,
                          per_atom=per_atom, target=NMR_TARGET if per_atom else TARGET,
                          batch=next(iter(loader)), single=(hp, gs),
                          profile=profile_all or (n_graph > 1 and not per_atom)))
    return cases


def mesh_steps(cases, world, backend, dev, torch):
    """Every case on `world` ranks (`mesh_rank`, started with
    `parallel.launch` under `backend`), and meanwhile the 1-rank SGD step
    on each whole batch on `dev`; after the world has ended, that step's
    time (median of MESH_REPS by CUDA events, the cases in turns). Returns (each rank's
    results, the 1-rank (loss, metric, gradients, parameters) and step ms
    per case, seconds of the world)."""
    from matten_tpu_torch.data.datamodule import BatchLoader
    from matten_tpu_torch.models import create_atomic_tensor_model, create_scalar_tensor_model
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.parallel.launch import start_ranks
    from matten_tpu_torch.predict import batch_to_device
    from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig

    smap = atomic_number_map(SPECIES_5)
    env = {"PYTHONPATH": str(Path(__file__).resolve().parent)}
    jobs = [{k: v for k, v in c.items() if k != "single"} for c in cases]
    refs, singles = {}, {}
    t0 = time.perf_counter()
    with start_ranks("chip_smoke:mesh_rank", world, jobs, timeout_s=MESH_TIMEOUT_S, threads=MESH_THREADS, env=env,
                     backend=backend) as ranks:
        for c in cases:
            hp, gs = c["single"]
            create = create_atomic_tensor_model if c["per_atom"] else create_scalar_tensor_model
            trainer = Trainer(create(hp, c["ds"], device=dev, seed=SEED),
                              [CanonicalRegressionTask(name=c["target"], per_atom=c["per_atom"])],
                              TrainerConfig(lr=0.01, optimizer="sgd", scheduler="none"), device=dev)
            data, targets = next(iter(BatchLoader(gs, batch_size=len(gs), species_map=smap, num_buckets=1)))
            batch = batch_to_device(data, dev, targets)
            loss, metrics = trainer.train_step(*batch)
            refs[c["name"]] = (float(loss), float(metrics[c["target"]][0]),
                               {n: p.grad.cpu().numpy() for n, p in trainer.model.named_parameters()},
                               {n: p.detach().cpu().numpy() for n, p in trainer.model.named_parameters()})
            singles[c["name"]] = (trainer, batch)
        steps = ranks.join()
    world_s = time.perf_counter() - t0
    # the cases in turns, after a warm-up step each
    times = {name: [] for name in singles}
    for r in range(MESH_REPS + 1):
        for name, (trainer, batch) in singles.items():
            t = cuda_ms(lambda: trainer.train_step(*batch), torch)
            if r:
                times[name].append(t)
    return steps, refs, {name: float(np.median(t)) for name, t in times.items()}, world_s


def check_mesh_steps(cases, steps, refs, one_ms, card, backend, world_s):
    """Each case's ranks against the 1-rank step on the whole batch: the
    loss and metric sum within 1e-5 relative, every gradient within
    MODEL_TOL of its largest entry, the parameters after the step within
    2e-5, all ranks bitwise equal; exact launches per step and rank (a
    plan per ring group under node_ring); each rank's kernels within
    KERNEL_TOL of their plain versions at its plans; under nccl no rank
    stages its ring shift through the host. Prints a line per case;
    returns the launches summed over the ranks, and the kernels' worst
    max |d|."""
    import torch

    launched = {k: 0 for k in COUNTERS}
    max_abs = {k: 0.0 for k in COUNTERS}
    world = len(steps)
    for c in cases:
        name, convs = c["name"], c["hparams"]["num_layers"] + 1
        rs = [s[name] for s in steps]
        r0 = rs[0]
        loss, metric, grads, params = refs[name]
        groups = c["n_graph"] if c["mode"] == "node_ring" else 1
        for r in rs:
            if r["launched"] != {k: convs * groups for k in COUNTERS}:
                raise AssertionError(f"{name}: launches in one train step {r['launched']}, expected "
                                     f"{convs * groups} of each kernel")
            if not r["kernel_rel"] <= KERNEL_TOL:
                raise AssertionError(f"{name}: a kernel disagrees with its plain version at a rank's plans: "
                                     f"{r['kernel_rel']}")
            for k in COUNTERS:
                launched[k] += r["launched"][k]
                max_abs[k] = max(max_abs[k], r["max_abs"][k])
        if backend == "nccl" and any(r["staged"] for r in rs):
            raise AssertionError(f"{name}: a rank staged its ring shift through the host under nccl")
        for i, r in enumerate(rs[1:], 1):
            for n in r0["params"]:
                if not (np.array_equal(r0["params"][n], r["params"][n])
                        and np.array_equal(r0["grads"][n], r["grads"][n])):
                    raise AssertionError(f"{name}: ranks 0 and {i} differ in {n}")
        loss_rel = abs(r0["loss"] - loss) / abs(loss)
        metric_rel = abs(r0["metric"] - metric) / abs(metric)
        grad_err = max((rel_err(torch.as_tensor(r0["grads"][n]), torch.as_tensor(g)), n) for n, g in grads.items())
        # parameters after the step (max |d|, and that relative to the step, lr x gradient)
        param_err = max((float(np.abs(r0["params"][n] - p).max()),
                         float(np.abs(r0["params"][n] - p).max()) / max(0.01 * float(np.abs(grads[n]).max()), 1e-30),
                         n) for n, p in params.items())
        if not (loss_rel <= 1e-5 and metric_rel <= 1e-5 and grad_err[0] <= MODEL_TOL and param_err[0] <= 2e-5):
            raise AssertionError(f"{name}: the {world}-rank step disagrees with the 1-rank step: loss {loss_rel}, "
                                 f"metric {metric_rel}, gradient {grad_err}, parameters {param_err}")
        if backend == "gloo":
            how = f"{world} ranks on the card (gloo" + (
                "; the ring shift staged through the host)" if c["mode"] == "node_ring" and r0["staged"] else ")")
            shared = "checks of the path: the ranks share one card"
        else:
            how = f"{world} ranks, a card each (nccl; no rank staged through the host)"
            shared = "a card per rank"
        print(f"[{name}] {card}: {how}, {c['n_data']} x {c['n_graph']} {c['mode']}, block "
              f"{tuple(c['batch'][0]['pos'].shape)} of pos: against the 1-rank SGD step on the whole batch, "
              f"loss {r0['loss']:.8f} vs {loss:.8f} ({loss_rel:.2e}, tol 1e-5), metric sum {metric_rel:.2e} "
              f"(tol 1e-5), gradients worst {grad_err[1]} {grad_err[0]:.3e} (tol {MODEL_TOL}), parameters "
              f"after the step worst {param_err[2]} max|d| {param_err[0]:.3e}, {param_err[1]:.3e} of its step "
              f"(tol 2e-5), ranks bitwise equal; launches per step and "
              f"rank {r0['launched']}; the kernels at each rank's plans vs plain worst "
              f"{max(r['kernel_rel'] for r in rs):.3e} (tol {KERNEL_TOL}); ms per layer L0-L3 (rank 0, every "
              f"rank at once): K1 with its sum "
              + " / ".join(f"{t:.4f}" for t in r0["kernel_ms"]["fwd"]) + ", the backward (merged kernel, dx sum) "
              + " / ".join(f"{t:.4f}" for t in r0["kernel_ms"]["bwd"])
              + ("" if r0["device_ms"] is None else "; plain K1 "
                 + " / ".join(f"{t:.4f}" for t in r0["plain_ms"]["fwd"]) + ", plain backward "
                 + " / ".join(f"{t:.4f}" for t in r0["plain_ms"]["bwd"]) + "; device ms per step (profiler, "
                 f"{MESH_PROFILED_STEPS} steps, rank 0): conv kernels "
                 + ", ".join(f"{k} {t:.4f}" for k, t in r0["device_ms"].items())
                 + f", NCCL kernels {r0['nccl_ms']:.4f}")
              + "; bound K1 "
              + " / ".join(f"{t:.4f}" for t, _ in r0["bounds"]["fwd"]) + ", backward "
              + " / ".join(f"{t:.4f}" for t, _ in r0["bounds"]["bwd"])
              + "; train step median ms (CUDA events) per rank "
              + " / ".join(f"{r['step_ms']:.2f}" for r in rs)
              + f", 1 rank on the whole batch {one_ms[name]:.2f} ({shared}); rank 0's seconds: "
              + ", ".join(f"{k} {t:.1f}" for k, t in zip(MESH_PHASES, r0["phase_s"]))
              + f"; world {world_s:.1f} s", flush=True)
    return launched, max_abs


def parallel_phases(dev, card, torch, structures, target_rows):
    """Phases 20-22 on 2 ranks that share the card (gloo, named): data
    parallel 2 x 1 and the graph modes at 1 x 2 against the 1-rank step,
    then the materials script on a node mesh. Returns their launches,
    summed over the ranks, and the kernels' worst max |d| there."""
    from matten_tpu_torch.parallel.launch import run_ranks
    from matten_tpu_torch.utils.config_yaml import load_config

    cases = mesh_cases(GLOO_CASES, structures, target_rows, profile_all=False)
    steps, refs, one_ms, steps_s = mesh_steps(cases, 2, "gloo", dev, torch)
    launched, max_abs = check_mesh_steps(cases, steps, refs, one_ms, card, "gloo", steps_s)

    env = {"PYTHONPATH": str(Path(__file__).resolve().parent)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train, val = fit_rows(4, FIT_TRAIN), fit_rows(5, FIT_VAL)
        write_records(tmp / "train.json", train)
        write_records(tmp / "val.json", val)
        config = load_config(CONFIGS / "materials_tensor_production.yaml")
        config["data"].update(root=str(tmp), trainset_filename="train.json", valset_filename="val.json",
                              testset_filename="val.json")
        config["trainer"].update(max_epochs=MESH_EPOCHS, checkpoint_dir=str(tmp / "mesh_ckpt"),
                                 devices=2, mesh={"data": 1, "graph": 2, "mode": "node"})
        config["restore"] = False
        t0 = time.perf_counter()
        script = run_ranks("chip_smoke:script_rank", 2, {"config": config, "rows": val[:16]},
                           timeout_s=MESH_TIMEOUT_S, threads=MESH_THREADS, env=env)
        script_s = time.perf_counter() - t0

    # 22. the materials script on a node mesh
    r0, r1 = script
    expect = fit_expected(HPARAMS["num_layers"] + 1, MESH_EPOCHS, FIT_TRAIN, FIT_VAL, FIT_VAL, 32)
    for r in (r0, r1):
        if r["launched"] != expect:
            raise AssertionError(f"22: a rank's launches {r['launched']}, expected {expect}")
        if not r["kernel_rel"] <= KERNEL_TOL:
            raise AssertionError(f"22: a kernel disagrees with its plain version at a rank's fit blocks: "
                                 f"{r['kernel_rel']}")
        for k in COUNTERS:
            launched[k] += r["launched"][k] + r["served"][k]
            max_abs[k] = max(max_abs[k], r["max_abs"][k])
    if r0["metrics"] != r1["metrics"] or not all(np.isfinite(list(r0["metrics"].values()))):
        raise AssertionError(f"22: test metrics {r0['metrics']} and {r1['metrics']}")
    if not r0["predict_err"] <= 1e-6:
        raise AssertionError(f"22: predict from the directory disagrees with rank 0's model: {r0['predict_err']}")
    if not {"hparams.json", "dataset_statistics.npz", "index.json", "last", "loop_state.json"} <= set(r0["files"]):
        raise AssertionError(f"22: the directory holds {r0['files']}")
    print(f"[22 mesh fit] {card}: train_materials_tensor.main with trainer.mesh {{data: 1, graph: 2, mode: "
          f"node}} on 2 ranks sharing the card (gloo), {FIT_TRAIN} train / {FIT_VAL} val crystals, batch 32, "
          f"{MESH_EPOCHS} epochs: launches per rank {r0['launched']} (expected {expect}); epoch times (s) rank 0 "
          + ", ".join(f"{h['epoch_time']:.4f}" for h in r0["history"]) + ", train edges/s "
          + ", ".join(f"{h['train/edges_per_s']:.1f}" for h in r0["history"])
          + f"; setup to fit {r0['setup_s']:.2f} / {r1['setup_s']:.2f} s; test metrics equal on both ranks "
          f"{json.dumps(r0['metrics'])}; the directory rank 0 wrote {r0['files']}; predict of 17 structures "
          f"from it against rank 0's in-memory best model {r0['predict_err']:.3e} (tol 1e-6), launches "
          f"{r0['served']}; against the plain versions at the fit's blocks, on each rank: evaluation of "
          f"the best model over train, val and test worst {r0['eval_err'][1]} "
          f"{max(r0['eval_err'][0], r1['eval_err'][0]):.3e} relative (tol {FIT_EVAL_TOL}), one train "
          f"step's gradients (summed over the ranks) on the first batch of each of the {len(r0['shapes'])} "
          f"block pad shapes (nodes, edges) {r0['shapes']} worst {r0['grad_err'][1]} "
          f"{max(r0['grad_err'][0], r1['grad_err'][0]):.3e} (tol {MODEL_TOL}), the kernels at those blocks' "
          f"plans worst {max(r0['kernel_rel'], r1['kernel_rel']):.3e} (tol {KERNEL_TOL}), max|d| "
          + json.dumps({k: max(r0["max_abs"][k], r1["max_abs"][k]) for k in COUNTERS})
          + f"; world {script_s:.1f} s", flush=True)
    return launched, max_abs



def yaml_lines(mapping, indent=0):
    """`mapping` as block YAML in the subset `utils/config_yaml.py` reads
    (pyyaml is not on the card): strings double-quoted, floats in
    positional notation (the subset reads `1e-05` as a string)."""
    def scalar(v):
        if v is None or isinstance(v, bool):
            return {None: "null", True: "true", False: "false"}[v]
        if isinstance(v, float):
            return np.format_float_positional(v)
        if isinstance(v, str):
            return json.dumps(v)
        return str(v)

    pad, lines = " " * indent, []
    for k, v in mapping.items():
        if isinstance(v, dict) and v:
            lines += [f"{pad}{k}:"] + yaml_lines(v, indent + 2)
        elif isinstance(v, list) and v:
            lines.append(f"{pad}{k}:")
            for item in v:
                if isinstance(item, dict):
                    sub = yaml_lines(item, indent + 4)
                    lines += [f"{pad}  - {sub[0].lstrip()}"] + sub[1:]
                else:
                    lines.append(f"{pad}  - {scalar(item)}")
        else:
            lines.append(f"{pad}{k}: {scalar(v)}")
    return lines


def write_config(path, config):
    """A config file the train scripts read back as `config`."""
    from matten_tpu_torch.utils.config_yaml import load_config

    path.write_text("\n".join(yaml_lines(config)) + "\n")
    if load_config(path) != config:
        raise AssertionError(f"{path} does not read back as the config written")


EPOCH_LOG = re.compile(r"epoch (\d+): train loss (\S+) \| val score (\S+) \| (\S+)s")
TEST_LOG = re.compile(r"test metrics \(best checkpoint\): (\{.*\})")
# what NCCL prints when a rank's device is not bound (device_id) before a
# collective or a barrier
UNBOUND_WARNINGS = ("Guessing device", "devices used by this process are currently unknown")


def torchrun_fit(n, card, torch):
    """`--cards n`'s fit: the materials script under torchrun, `torchrun
    --standalone --nproc-per-node n -m
    matten_tpu_torch.scripts.train_materials_tensor CONFIG`, with the
    production yaml on a data 1 x graph n node mesh (which keeps the whole
    graph's batch-norm statistics, so it computes what one card does),
    phase 16's data, MESH_EPOCHS epochs; against the same config fitted on
    card 0 in this process (`trainer.devices: 1`): each epoch's train loss
    and val score as the script logs them (5 decimals, the one-card values
    rounded alike) and the test metrics within 1e-4 relative, the same
    files in both directories, `predict` from both within 1e-5; no NCCL
    warning of an unbound device in the ranks' log."""
    from matten_tpu_torch.data.structure import Structure
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.predict import predict
    from matten_tpu_torch.scripts import train_materials_tensor
    from matten_tpu_torch.utils.config_yaml import load_config

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train, val = fit_rows(4, FIT_TRAIN), fit_rows(5, FIT_VAL)
        write_records(tmp / "train.json", train)
        write_records(tmp / "val.json", val)
        base = load_config(CONFIGS / "materials_tensor_production.yaml")
        base["data"].update(root=str(tmp), trainset_filename="train.json", valset_filename="val.json",
                            testset_filename="val.json")
        base["trainer"].update(max_epochs=MESH_EPOCHS)
        base["restore"] = False
        one, many = copy.deepcopy(base), copy.deepcopy(base)
        one["trainer"].update(devices=1, checkpoint_dir=str(tmp / "one_card"))
        many["trainer"].update(devices=n, mesh={"data": 1, "graph": n, "mode": "node"},
                               checkpoint_dir=str(tmp / f"{n}_cards"))
        write_config(tmp / "mesh.yaml", many)

        t0 = time.perf_counter()
        metrics1, trainer1, setup1, launched1 = run_script(train_materials_tensor, one, fused_conv, torch)
        one_s = time.perf_counter() - t0
        expect = fit_expected(HPARAMS["num_layers"] + 1, MESH_EPOCHS, FIT_TRAIN, FIT_VAL, FIT_VAL, 32)
        if launched1 != expect:
            raise AssertionError(f"the one-card fit's launches {launched1}, expected {expect}")

        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(n), "-m",
               "matten_tpu_torch.scripts.train_materials_tensor", str(tmp / "mesh.yaml")]
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=MESH_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        many_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torchrun's fit on {n} cards exited with {proc.returncode}:\n{log[-6000:]}")
        unbound = [w for w in UNBOUND_WARNINGS if w in log]
        if unbound:
            raise AssertionError(f"NCCL warned of an unbound device ({unbound}):\n{log[-6000:]}")
        if f"mesh: data=1 graph={n} mode=node" not in log:
            raise AssertionError(f"torchrun's fit did not run on the mesh:\n{log[-6000:]}")
        epochs = [(int(e), float(loss), float(score), float(t)) for e, loss, score, t in EPOCH_LOG.findall(log)]
        tests = TEST_LOG.findall(log)
        if len(epochs) != MESH_EPOCHS or len(tests) != 1:
            raise AssertionError(f"torchrun's log holds {len(epochs)} epoch lines and {len(tests)} test lines:\n"
                                 f"{log[-6000:]}")
        metrics = ast.literal_eval(tests[0])

        def rel(a, b):
            return abs(a - b) / max(abs(b), 1e-30)

        errs = []
        for (e, loss, score, _), h in zip(epochs, trainer1.history):
            errs += [(rel(loss, float(f"{h['train/loss']:.5f}")), f"epoch {e} train loss"),
                     (rel(score, float(f"{h['val/score']:.5f}")), f"epoch {e} val score")]
        if sorted(metrics) != sorted(metrics1):
            raise AssertionError(f"test metrics {sorted(metrics)} against one card's {sorted(metrics1)}")
        errs += [(rel(metrics[k], metrics1[k]), f"test {k}") for k in metrics1]
        worst = max(errs)
        if not worst[0] <= 1e-4:
            raise AssertionError(f"the {n}-card fit disagrees with the one-card fit: {sorted(errs, reverse=True)[:3]}")
        dirs = (tmp / f"{n}_cards", tmp / "one_card")
        files = [sorted(p.name for p in d.iterdir()) for d in dirs]
        if files[0] != files[1] or not {"hparams.json", "dataset_statistics.npz", "index.json", "last",
                                        "loop_state.json"} <= set(files[0]):
            raise AssertionError(f"the directories hold {files[0]} and {files[1]}")
        structures = [Structure.from_dict(r["structure"]) for r in val[:16]] + [si_structure()]
        served = [predict(structures, d) for d in dirs]
        if not all(r is not None and r.shape == (3, 3, 3, 3) and np.isfinite(r).all() for r in served[0]):
            raise AssertionError("predict from the n-card directory gave no finite [3,3,3,3] tensor")
        predict_err = max_rel(served[0], served[1])
        if not predict_err <= 1e-5:
            raise AssertionError(f"predict from the {n}-card directory against the one-card one: {predict_err}")
    print(f"[fit {n} cards] {card}: torchrun --standalone --nproc-per-node {n} -m "
          f"matten_tpu_torch.scripts.train_materials_tensor with materials_tensor_production.yaml, trainer.mesh "
          f"{{data: 1, graph: {n}, mode: node}}, {FIT_TRAIN} train / {FIT_VAL} val crystals, batch 32, "
          f"{MESH_EPOCHS} epochs (nccl): exit 0 in {many_s:.1f} s, no unbound-device warning; against the "
          f"one-card fit on card 0 ({one_s:.1f} s, setup {setup1:.2f} s, launches {launched1}): epochs (train "
          "loss, val score; logged to 5 decimals) "
          + "; ".join(f"{e}: {loss:.5f} vs {h['train/loss']:.8f}, {score:.5f} vs {h['val/score']:.8f}"
                      for (e, loss, score, _), h in zip(epochs, trainer1.history))
          + f"; test metrics {json.dumps(metrics)} vs {json.dumps(metrics1)}; worst {worst[1]} {worst[0]:.3e} "
          f"relative (tol 1e-4); epoch times (s) {n} cards "
          + ", ".join(f"{t:.2f}" for *_, t in epochs) + ", one card "
          + ", ".join(f"{h['epoch_time']:.2f}" for h in trainer1.history)
          + f"; both directories {files[0]}; predict of {len(structures)} structures from them "
          f"{predict_err:.3e} apart (tol 1e-5)", flush=True)


def cards_phases(n, dev, card, torch):
    """`--cards n`: the step cases of `card_cases(n)` on n ranks, a card
    each under nccl, against the 1-rank step on card 0; then the materials
    script under torchrun on n cards against one card."""
    structures, target_rows = draw_structures()
    cases = mesh_cases(card_cases(n), structures, target_rows, profile_all=True)
    steps, refs, one_ms, world_s = mesh_steps(cases, n, "nccl", dev, torch)
    check_mesh_steps(cases, steps, refs, one_ms, card, "nccl", world_s)
    torchrun_fit(n, card, torch)


# phase 23: bf16 storage of the conv kernels' edge inputs sh and w
BF16_NOISE_TOL = 3e-2  # the JAX package's bf16-storage test: |d| / max(max|ref|, 1)


@contextlib.contextmanager
def kernel_in_dtype(name):
    """`fused_tp.set_kernel_in_dtype(name)` for the block, restored after."""
    from matten_tpu_torch.kernels import fused_tp

    prev = fused_tp.get_kernel_in_dtype()
    fused_tp.set_kernel_in_dtype(name)
    try:
        yield
    finally:
        fused_tp.set_kernel_in_dtype(prev)


def noise(out, ref):
    """max|d| / max(max|ref|, 1): the JAX bf16-storage test's measure."""
    return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def bf16_phase(dev, card, torch, check_forward, check_backward, layer_inputs, sh, src, dst, edges,
               model, trainer, data, targets, nmr_trainer, nmr_batch, f32_layer_ms):
    """Phase 23: K1 and the merged backward reading sh and w stored as
    bf16 (`set_kernel_in_dtype("bfloat16")`): parity with their plain
    versions at the same rounding (KERNEL_TOL, bitwise twice) at the 4
    flagship and the 4 NMR plans and at N = BIG_N; the flagship forward and
    one train step at bf16 against the kernels at float32 (bf16 noise, held
    to BF16_NOISE_TOL of scale); the forward and a train step counted (4
    launches of each bf16 counter); per-layer times against the plain
    versions at bf16, beside their bounds with sh and w at 2 bytes; the
    forward and the train step, and the conv kernels' device time per step
    (the profiler), at bf16 against float32 in the same call. Returns
    (launch counts of the counted runs, per-layer ms, per-layer bounds)."""
    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.ops.spherical_harmonics import spherical_harmonics

    n_nodes, n_edges = data[K.POSITIONS].shape[0], sh.shape[0]
    # the NMR batch's 4 plans on its own edges
    nmr_data = nmr_batch[0]
    n_src, n_dst = (nmr_data[K.EDGE_INDEX][i].contiguous() for i in (0, 1))
    nmr_n = nmr_data[K.POSITIONS].shape[0]
    nmr_sh = (spherical_harmonics(NMR_HPARAMS["irreps_edge_sh"], nmr_data[K.EDGE_VECTORS])
              * nmr_data[K.EDGE_MASK][:, None].float()).contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    parity = []
    with kernel_in_dtype("bfloat16"):
        for i, (plan, x, w, g) in enumerate(layer_inputs):
            parity.append(f"L{i}: " + check_forward(plan, x, w, sh, src, dst, n_nodes)[1] + "; "
                          + check_backward(plan, x, w, g, sh, src, dst, n_nodes))
        for i, conv in enumerate(conv_layers(nmr_trainer.model)):
            plan = conv.uvu_plan
            x = torch.randn(nmr_n, plan.irreps_in1.dim, generator=gen, device=dev)
            w = torch.randn(n_src.shape[0], plan.weight_numel, generator=gen, device=dev)
            g = torch.randn(nmr_n, plan.irreps_out.dim, generator=gen, device=dev)
            parity.append(f"NMR L{i}: " + check_forward(plan, x, w, nmr_sh, n_src, n_dst, nmr_n)[1] + "; "
                          + check_backward(plan, x, w, g, nmr_sh, n_src, n_dst, nmr_n))
        plan = layer_inputs[-1][0]
        big_e = BIG_N * BIG_DEGREE
        big = dict(
            x=torch.randn(BIG_N, plan.irreps_in1.dim, generator=gen, device=dev),
            w=torch.randn(big_e, plan.weight_numel, generator=gen, device=dev),
            g=torch.randn(BIG_N, plan.irreps_out.dim, generator=gen, device=dev),
            sh=torch.randn(big_e, plan.irreps_in2.dim, generator=gen, device=dev),
            src=torch.randint(0, BIG_N, (big_e,), generator=gen, device=dev, dtype=torch.int32),
            dst=torch.sort(torch.randint(0, BIG_N, (big_e,), generator=gen, device=dev,
                                         dtype=torch.int32))[0],
        )
        parity.append(f"N={BIG_N} E={big_e} L3 plan: " + check_forward(
            plan, big["x"], big["w"], big["sh"], big["src"], big["dst"], BIG_N)[1] + "; " + check_backward(
            plan, big["x"], big["w"], big["g"], big["sh"], big["src"], big["dst"], BIG_N))
    del big
    torch.cuda.empty_cache()
    print(f"[23a bf16 kernel parity] sh and w stored as bf16, against the plain versions at the same "
          f"rounding, max|d|/max|ref| (tol {KERNEL_TOL}), two runs bitwise equal: " + " | ".join(parity),
          flush=True)

    # the flagship forward and one step's gradients at bf16 against the kernels at float32
    def fwd():
        with torch.inference_mode():
            return model(data)

    real = data[K.GRAPH_MASK]
    out32 = fwd()
    with kernel_in_dtype("bfloat16"):
        reset_counts(fused_conv)
        out16 = fwd()
        torch.cuda.synchronize()
        fwd_counts = {**counts(fused_conv), **counts(fused_conv, BF16_COUNTERS)}
    fwd_noise = noise(out16[real], out32[real])
    tr32, tr16 = twin(trainer, torch), twin(trainer, torch)
    loss32, grads32 = step_grads(tr32, data, targets)
    with kernel_in_dtype("bfloat16"):
        loss16, grads16 = step_grads(tr16, data, targets)
    grad_noise = sorted(((noise(grads16[n], r), n) for n, r in grads32.items()), reverse=True)
    tr16.model.load_state_dict(tr32.model.state_dict())
    # the train step at bf16, counted
    with kernel_in_dtype("bfloat16"):
        reset_counts(fused_conv)
        loss, _ = tr16.train_step(data, targets)
        torch.cuda.synchronize()
        step_counts = {**counts(fused_conv), **counts(fused_conv, BF16_COUNTERS)}
    n_conv = len(layer_inputs)
    want_fwd = {"fwd": 0, "bwd": 0, "fwd_sum": n_conv, "dx_sum": 0, "fwd_bf16": n_conv, "bwd_bf16": 0}
    want_step = {"fwd": 0, "bwd": 0, "fwd_sum": n_conv, "dx_sum": n_conv, "fwd_bf16": n_conv, "bwd_bf16": n_conv}
    print(f"[23b bf16 model] forward max|d|/max(max|ref|, 1) bf16 vs float32 storage {fwd_noise:.3e}; "
          f"train-step loss {loss16:.6f} vs {loss32:.6f}, gradients worst: "
          + ", ".join(f"{n} {e:.3e}" for e, n in grad_noise[:3])
          + f" (bf16 noise, tol {BF16_NOISE_TOL}); launches per forward {fwd_counts}, per train step "
          f"{step_counts}; loss {float(loss):.6f}", flush=True)
    if fwd_counts != want_fwd or step_counts != want_step:
        raise AssertionError(f"bf16 launches per forward {fwd_counts} / step {step_counts}, expected "
                             f"{want_fwd} / {want_step}")
    if not (fwd_noise <= BF16_NOISE_TOL and grad_noise[0][0] <= BF16_NOISE_TOL and math.isfinite(float(loss))):
        raise AssertionError(f"bf16 storage moves the model beyond its noise: forward {fwd_noise}, "
                             f"gradients {grad_noise[0]}")

    # timings: per layer the bf16 kernels (sh and w cast once, as the
    # wrappers pass them) against the plain versions at bf16; the forward
    # and the train step at bf16 vs float32; the conv kernels' device time
    # per step at bf16 vs float32 (the wrapper times are host-bound)
    layer_ms = {"fwd_bf16": [], "bwd_bf16": []}
    bounds = {"fwd_bf16": [], "bwd_bf16": []}
    with kernel_in_dtype("bfloat16"):
        for plan, x, w, g in layer_inputs:
            sh16, w16 = sh.bfloat16(), w.bfloat16()
            with torch.no_grad():
                layer_ms["fwd_bf16"].append(interleaved(
                    lambda: fused_conv._launch(plan, x, sh16, w16, edges),
                    lambda: fused_conv.uvu_conv_reference(plan, x, sh, w, src, dst, n_nodes), torch))
                layer_ms["bwd_bf16"].append(interleaved(
                    lambda: fused_conv._launch_bwd_edges(plan, x, g, sh16, w16, edges),
                    lambda: fused_conv.uvu_conv_bwd_reference(plan, x, g, sh, w, src, dst, n_nodes),
                    torch))
            work = kernel_work(plan, n_nodes, n_nodes, n_edges, int(edges.item_ptr[-1]), in_bytes=2)
            for kind in bounds:
                bounds[kind].append(bound_ms(*work[kind.replace("_bf16", "")]))

    def fwd16():
        with kernel_in_dtype("bfloat16"):
            return fwd()

    def step16():
        with kernel_in_dtype("bfloat16"):
            tr16.train_step(data, targets)

    fwd_t = interleaved(fwd16, fwd, torch)
    step_t = interleaved(step16, lambda: tr32.train_step(data, targets), torch)
    # device time per train step of the conv kernels, float32 then bf16 storage
    dev_ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fn in (("float32", lambda: tr32.train_step(data, targets)), ("bf16", step16)):
            _, st_ = traced(fn, PROFILED_FORWARDS, Path(tmp), f"{label}_step", torch)
            dev_ms[label] = {k: (sum(t for n, t in st_["by_kernel"].items() if is_kind(n, k)),
                                 st_["per_layer"][k] if k == "fwd" else st_["per_layer"][k][::-1])
                             for k in ("fwd", "bwd")}
            dev_ms[label]["busy"] = st_["busy_ms"]
            instance = [n for n in st_["by_kernel"] if is_kind(n, "fwd") or is_kind(n, "bwd")]
            if any(("bfloat16" in n) != (label == "bf16") for n in instance):
                raise AssertionError(f"the {label} step ran the kernel instances {instance}")
    per_layer = "; ".join(
        f"{kind} " + " / ".join(f"{k:.4f} vs {p:.4f} (float32 kernel, phase 9: {k9:.4f})"
                               for (k, p), (k9, _) in zip(layer_ms[kind], f32_layer_ms[kind.replace("_bf16", "")]))
        for kind in layer_ms)
    bound_txt = "; ".join(
        f"{kind} " + " / ".join(f"{b:.4f} ({by})" for b, by in bounds[kind]) for kind in bounds)
    print(f"[23c bf16 timings] {card}: flagship batch, median ms, sh and w stored as bf16: forward "
          f"{fwd_t[0]:.4f} vs {fwd_t[1]:.4f} float32; train step {step_t[0]:.4f} vs {step_t[1]:.4f} float32; "
          f"per layer L0 / L1 / L2 / L3, the bf16 kernel vs the plain version at bf16 (fwd: K1 with its "
          f"partial-row sum; bwd: the merged kernel): {per_layer}; bound ms per layer at 2-byte sh and w: "
          f"{bound_txt}; device ms per train step (profiler, {PROFILED_FORWARDS} steps), bf16 vs float32: "
          + "; ".join(f"{k} {dev_ms['bf16'][k][0]:.4f} vs {dev_ms['float32'][k][0]:.4f} (per layer "
                      + " / ".join(f"{a:.4f} vs {b:.4f}" for a, b in zip(dev_ms["bf16"][k][1], dev_ms["float32"][k][1]))
                      + ")" for k in ("fwd", "bwd"))
          + f"; device busy {dev_ms['bf16']['busy']:.4f} vs {dev_ms['float32']['busy']:.4f}", flush=True)
    return {"fwd_bf16": fwd_counts["fwd_bf16"] + step_counts["fwd_bf16"],
            "bwd_bf16": step_counts["bwd_bf16"]}, layer_ms, bounds


def debug_phase(dev, card, torch, model, data):
    """Phase 24: the production model built at DEBUG log level (a
    `DetectAnomaly` after every backbone layer) with the INFO model's
    weights, its output bitwise equal to the INFO model's; a NaN put into
    one node feature after the first layer raises FloatingPointError naming
    the field and the layer; one `StepTimer` step reports edges/s and
    `profile_trace` writes a trace."""
    import re

    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.utils.anomaly import DetectAnomaly
    from matten_tpu_torch.utils.logging import get_log_level, set_logger
    from matten_tpu_torch.utils.timing import StepTimer, profile_trace

    prev = get_log_level()
    set_logger("DEBUG", filename=None)
    try:
        debug = create_scalar_tensor_model(HPARAMS, DATASET_HPARAMS, device=dev, seed=SEED).eval()
    finally:
        set_logger(prev, filename=None)
    n_checks = sum(isinstance(m, DetectAnomaly) for m in debug.backbone.layers)
    # the INFO backbone's layer i is the DEBUG backbone's layer 2 i
    debug.load_state_dict({re.sub(r"^backbone\.layers\.(\d+)\.", lambda m: f"backbone.layers.{2 * int(m[1])}.", k): v
                           for k, v in model.state_dict().items()})
    # the mean pooling's index_add_ adds with atomics on the card unless
    # deterministic algorithms are asked for (the conv kernels always are)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.inference_mode():
            out_info, out_debug = model(data), debug(data)
    finally:
        torch.use_deterministic_algorithms(False)
    if not torch.equal(out_info, out_debug):
        raise AssertionError("the DEBUG-built model's output differs from the INFO model's")

    def poison(_module, _inputs, out):
        out[K.NODE_FEATURES][0, 0] = float("nan")
        return out

    hook = debug.backbone.layers[0].register_forward_hook(poison)
    try:
        with torch.inference_mode():
            debug(data)
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("a NaN in the node features did not raise at DEBUG level")
    finally:
        hook.remove()
    if "'node_features'" not in raised or "species_embedding" not in raised:
        raise AssertionError(f"the DEBUG check names another field or layer: {raised}")

    timer = StepTimer()
    n_edges = int(data[K.EDGE_MASK].sum())
    with torch.inference_mode():
        # the step ends when the card behind the batch has finished
        with timer.step(data[K.POSITIONS], num_edges=n_edges):
            out = model(data)
        with tempfile.TemporaryDirectory() as logdir:
            with profile_trace(logdir):
                model(data)
                torch.cuda.synchronize()
            trace = Path(logdir, "trace.json").read_text()
    json.loads(trace)
    kernels_traced = "fused_uvu_conv_fwd" in trace
    if not (timer.edges_per_s > 0 and bool(torch.isfinite(out).all())):
        raise AssertionError(f"StepTimer: {timer.edges_per_s} edges/s")
    print(f"[24 DEBUG and timing] {card}: DEBUG model ({n_checks} anomaly checks) bitwise equal to the "
          f"INFO model; NaN after layer 0 raised: {raised}; StepTimer one forward "
          f"{timer.seconds * 1e3:.3f} ms, {timer.edges_per_s:.4g} real edges/s; profile_trace wrote "
          f"{len(trace)} bytes of Chrome trace, K1 in it: {kernels_traced}", flush=True)


WIDE_STEPS = 2  # train steps of each phase-25 model, each held to the plain gradients
WIDE_REPS = 10  # timed kernel calls per layer in phase 25 (the plain versions: one)


def wide_phase(dev, card, torch, check_forward, check_backward, data, targets, src, dst):
    """Phase 25: the configurations of WIDE_CONFIGS, past the production
    plans' shared memory, at full depth on the flagship batch with seeded
    weights: each layer's tiers (and bytes per block) at float32 and bf16
    storage; K1 (item pass and sum) and the merged backward (with the dx
    sum) at each layer's plan against their plain versions at both storage
    widths (KERNEL_TOL, two runs bitwise equal); the forward against
    `force_plain()` (MODEL_TOL) with exactly one launch per conv layer of
    each of K1's kernels at the layer's tier, then WIDE_STEPS Adam steps,
    each step's gradients against `force_plain()` (MODEL_TOL) and its
    launches exact per tier; per layer the kernels' ms per call (CUDA
    events over WIDE_REPS back-to-back calls) against one plain call and
    `kernel_work`'s bound, and their device ms per train step (the
    profiler). Returns the main-path launches of K1 and the backward (the
    counted forward and steps), per tier, the kernels' max |d| at float32
    and bf16, and per-layer times and bounds."""
    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.ops.spherical_harmonics import spherical_harmonics
    from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig

    n_nodes, n_edges = data[K.POSITIONS].shape[0], src.shape[0]
    real = data[K.GRAPH_MASK]
    errs = {k: 0.0 for k in (*COUNTERS, *BF16_COUNTERS)}
    launched = {k: 0 for k in COUNTERS}
    tiers = Counter()
    layer_ms = {"fwd": [], "bwd": []}
    plain_ms = {"fwd": [], "bwd": []}
    bounds = {"fwd": [], "bwd": []}
    task = CanonicalRegressionTask(name=TARGET)
    for name, hp in WIDE_CONFIGS.items():
        model = create_scalar_tensor_model(hp, DATASET_HPARAMS, device=dev, seed=SEED).eval()
        plans = [c.uvu_plan for c in conv_layers(model)]
        sh = spherical_harmonics(hp["irreps_edge_sh"], data[K.EDGE_VECTORS])
        sh = (sh * data[K.EDGE_MASK][:, None].float()).contiguous()
        layer_tiers = {b: [fused_conv.launch_tiers(p, dev, b) for p in plans] for b in (4, 2)}
        tier_txt = "; ".join(
            f"L{i} d1={p.irreps_in1.dim} dw={p.weight_numel} dout={p.irreps_out.dim} n_t="
            f"{fused_conv.kernel_tables(p).t_meta.shape[0]}: "
            + ", ".join(f"{'float32' if b == 4 else 'bf16'} K1 {f.label('fwd')} {f.smem} B, backward "
                        f"{bw.label('bwd')} {bw.smem} B" for b in (4, 2) for f, bw in [layer_tiers[b][i]])
            for i, p in enumerate(plans))
        print(f"[25 {name} tiers] {hp['irreps_edge_sh']} x {hp['conv_layer_irreps']}: {tier_txt}", flush=True)

        # each layer's kernels against their plain versions, float32 and bf16
        gen = torch.Generator(device=dev).manual_seed(SEED + 25)
        edges = fused_conv.edge_plan(src, dst, n_nodes, n_nodes, with_src_order=True,
                                     item_edges=fused_conv.item_edges_for(plans, dev))
        parity, times = [], []
        for i, plan in enumerate(plans):
            x = torch.randn(n_nodes, plan.irreps_in1.dim, generator=gen, device=dev)
            w = torch.randn(n_edges, plan.weight_numel, generator=gen, device=dev)
            w = (w * data[K.EDGE_MASK][:, None].float()).contiguous()
            g = torch.randn(n_nodes, plan.irreps_out.dim, generator=gen, device=dev)
            txt = []
            for dtype in ("float32", "bfloat16"):
                with kernel_in_dtype(dtype):
                    txt.append(f"{dtype} K1 {check_forward(plan, x, w, sh, src, dst, n_nodes, record=errs)[1]}; "
                               + check_backward(plan, x, w, g, sh, src, dst, n_nodes, record=errs))
            parity.append(f"L{i}: " + " | ".join(txt))
            with torch.no_grad():
                fns = {"fwd": (lambda: fused_conv.fused_uvu_conv(plan, x, sh, w, src, dst, n_nodes, edges),
                               lambda: fused_conv.uvu_conv_reference(plan, x, sh, w, src, dst, n_nodes)),
                       "bwd": (lambda: fused_conv._launch_bwd_edges(plan, x, g, sh, w, edges),
                               lambda: fused_conv.uvu_conv_bwd_reference(plan, x, g, sh, w, src, dst, n_nodes))}
                for kind, (fn, plain) in fns.items():
                    for _ in range(WARMUP):
                        fn()
                    layer_ms[kind].append(cuda_ms(lambda: [fn() for _ in range(WIDE_REPS)], torch) / WIDE_REPS)
                    plain_ms[kind].append(cuda_ms(plain, torch))
            n_items = int(edges.items(layer_tiers[4][i][0].edges)[0][-1])
            work = kernel_work(plan, n_nodes, n_nodes, n_edges, n_items)
            for kind in bounds:
                bounds[kind].append(bound_ms(*work[kind]))
            times.append(f"L{i} K1 {layer_ms['fwd'][-1]:.4f} vs {plain_ms['fwd'][-1]:.4f} (bound "
                         f"{bounds['fwd'][-1][0]:.4f}, {n_items} items), backward {layer_ms['bwd'][-1]:.4f} vs "
                         f"{plain_ms['bwd'][-1]:.4f} (bound {bounds['bwd'][-1][0]:.4f})")
            del x, w, g
        print(f"[25 {name} kernels] max|d|/max|ref| (tol {KERNEL_TOL}), two runs bitwise equal, "
              + "; ".join(parity), flush=True)

        # the forward, counted, against the plain path
        fwd_tiers = Counter(("fwd", f.label("fwd")) for f, _ in layer_tiers[4])
        reset_counts(fused_conv)
        with torch.inference_mode():
            out_k = model(data)
        torch.cuda.synchronize()
        per_fwd, per_fwd_tiers = counts(fused_conv), Counter(fused_conv.tier_launches)
        with fused_conv.force_plain(), torch.inference_mode():
            out_p = model(data)
        if per_fwd != {"fwd": len(plans), "fwd_sum": len(plans), "bwd": 0, "dx_sum": 0} or per_fwd_tiers != fwd_tiers:
            raise AssertionError(f"{name}: launches per forward {per_fwd}, by tier {per_fwd_tiers}; expected "
                                 f"{len(plans)} of K1's two kernels, by tier {fwd_tiers}")
        if counts(fused_conv) != per_fwd:
            raise AssertionError(f"{name}: the plain forward launched a kernel")
        if tuple(out_k.shape) != (real.shape[0], 21) or not bool(torch.isfinite(out_k).all()):
            raise AssertionError(f"{name}: model output {tuple(out_k.shape)} not finite [G, 21]")
        fwd_rel = rel_err(out_k[real], out_p[real])
        if not fwd_rel <= MODEL_TOL:
            raise AssertionError(f"{name}: the forward through the kernels disagrees with the plain path: {fwd_rel}")
        launched = {k: launched[k] + v for k, v in per_fwd.items()}
        tiers += per_fwd_tiers

        # WIDE_STEPS train steps through the kernels, each step's gradients
        # against a copy under force_plain
        step_tiers = fwd_tiers + Counter(("bwd", b.label("bwd")) for _, b in layer_tiers[4])
        config = TrainerConfig(lr=0.01)
        trainer = Trainer(create_scalar_tensor_model(hp, DATASET_HPARAMS, device=dev, seed=SEED), [task], config,
                          device=dev)
        trainer_p = Trainer(copy.deepcopy(trainer.model), [task], config, device=dev)
        steps = []
        for step in range(WIDE_STEPS):
            loss_k, grads_k = step_grads(trainer, data, targets)
            with fused_conv.force_plain():
                loss_p, grads_p = step_grads(trainer_p, data, targets)
            worst = max((rel_err(grads_k[n], r), n) for n, r in grads_p.items())
            if not worst[0] <= MODEL_TOL:
                raise AssertionError(f"{name}: step {step}'s gradients disagree with the plain path: {worst}")
            reset_counts(fused_conv)
            loss, _ = trainer.train_step(data, targets)
            torch.cuda.synchronize()
            step_counts, by_tier = counts(fused_conv), Counter(fused_conv.tier_launches)
            if any(v != len(plans) for v in step_counts.values()) or by_tier != step_tiers:
                raise AssertionError(f"{name}: launches in a train step {step_counts}, by tier {by_tier}; "
                                     f"expected {len(plans)} of each kernel, by tier {step_tiers}")
            if not math.isfinite(float(loss)):
                raise AssertionError(f"{name}: train loss {float(loss)} not finite")
            launched = {k: launched[k] + v for k, v in step_counts.items()}
            tiers += by_tier
            trainer_p.model.load_state_dict(trainer.model.state_dict())
            steps.append(f"step {step}: loss {loss_k:.6f} vs {loss_p:.6f} plain, gradients worst "
                         f"{worst[1]} {worst[0]:.3e}; loss after {float(loss):.6f}")
        # the conv kernels' device time per train step (the profiler)
        with tempfile.TemporaryDirectory() as tmp:
            _, st = traced(lambda: trainer.train_step(data, targets), WIDE_STEPS, Path(tmp), f"{name}_step", torch)
        dev_ms = {k: (sum(t for n_, t in st["by_kernel"].items() if is_kind(n_, k)),
                      st["per_layer"][k] if k in ("fwd", "fwd_sum") else st["per_layer"][k][::-1])
                  for k in KERNEL_NAMES}
        print(f"[25 {name} model] {card}: forward max|d|/max|ref| kernels vs plain {fwd_rel:.3e} (tol {MODEL_TOL}), "
              f"launches {per_fwd}, by tier {dict(per_fwd_tiers)}; " + "; ".join(steps)
              + f" (tol {MODEL_TOL}); per step launches {step_counts}, by tier {dict(by_tier)}; ms per call "
              f"(CUDA events, {WIDE_REPS} calls) against one plain call: " + "; ".join(times)
              + f"; device ms per train step (profiler, {WIDE_STEPS} steps): "
              + "; ".join(f"{k} {t:.4f} (" + " / ".join(f"{v:.4f}" for v in per) + ")"
                          for k, (t, per) in dev_ms.items())
              + f"; device busy {st['busy_ms']:.4f} of a {st['span_ms']:.4f} ms span", flush=True)
        del model, trainer, trainer_p, edges, sh
        torch.cuda.empty_cache()
    return launched, tiers, errs, layer_ms, plain_ms, bounds


# phase 26: the train and eval steps replayed as CUDA graphs (train/graphs.py)
GRAPH_STEPS = 8  # graphed train steps against as many eager ones, the lr halved after GRAPH_LR_STEP
GRAPH_LR_STEP = 4
GRAPH_LOSS_TOL = 1e-5  # the same kernels in the same order; pooling's atomic index_add_ may reorder sums
GRAPH_PROFILED_STEPS = 5


def graph_phase(label, dev, card, torch, trainer, batches):
    """Phase 26 on one family: a graphed trainer over a deep copy of
    `trainer`'s model and optimizer state against an eager one
    (`eager`, the same capturable Adam) from the same state, step for
    step: GRAPH_STEPS train steps on batch A with the lr halved after
    GRAPH_LR_STEP (the train graph captured anew), then batch B, another pad
    shape (eager, capture, replay) and A again, then `load_state_dict` of
    the state after step GRAPH_LR_STEP (captured anew) and 2 steps; each
    step's loss and metric sums within GRAPH_LOSS_TOL relative, the
    parameters and Adam moments at the end within MODEL_TOL of their
    largest entry; 3 eval steps (eager, capture, replay) against eager.
    Every replay runs under `set_sync_debug_mode("error")` and launches
    exactly one of each kernel per conv layer. Then host ms per step,
    graphed against eager (synced wall clock), the device's busy share of a
    profiled step and its conv kernels in the trace by kind (equal to what
    the counters added), the bytes of the graphs' pools and the capture
    time of each key. Returns the graphed trainer's launches in the checked steps."""
    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.train import Trainer, TrainerConfig
    from matten_tpu_torch.train.graphs import batch_key

    config = TrainerConfig(lr=0.01, weight_decay=trainer.config.weight_decay)
    g = Trainer(copy.deepcopy(trainer.model), trainer.tasks, config, device=dev)
    e = eager(Trainer(copy.deepcopy(trainer.model), trainer.tasks, config, device=dev))
    if g._graphs is None or e._graphs is not None or not g.optimizer.defaults["capturable"]:
        raise AssertionError(f"{label}: the graphed trainer has no step graphs or the eager one has")
    convs = len(conv_layers(g.model))
    a, b = batches
    launched = {k: 0 for k in COUNTERS}
    errs, replays = [], 0

    def step(kind, batch):
        nonlocal replays
        # a replay: the step's kind and batch key were captured before
        replay = any(k[0] == kind.split("_")[0] and k[-1] == batch_key(*batch) for k in g._graphs.graphs)
        before = counts(fused_conv)
        if replay:
            replays += 1
            torch.cuda.set_sync_debug_mode("error")
        try:
            lg, mg = getattr(g, kind)(*batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = {k: v - before[k] for k, v in counts(fused_conv).items()}
        want = {k: convs if kind == "train_step" or k.startswith("fwd") else 0 for k in COUNTERS}
        if got != want:
            raise AssertionError(f"{label}: launches of one {kind} {got}, expected {want}")
        for k in COUNTERS:
            launched[k] += got[k]
        le, me = getattr(e, kind)(*batch)
        for name, x, y in [("loss", lg, le)] + [(f"{t} {j}", mg[t][j], me[t][j]) for t in me for j in (0, 1)]:
            err = abs(float(x) - float(y)) / max(abs(float(y)), 1e-30)
            errs.append(err)
            if not err <= GRAPH_LOSS_TOL:
                raise AssertionError(f"{label}: graphed {kind} {name} {float(x)!r} against eager {float(y)!r}")
        return float(lg)

    losses, saved = [], None
    for i in range(GRAPH_STEPS):
        losses.append(step("train_step", a))
        if i + 1 == GRAPH_LR_STEP:
            saved = copy.deepcopy(g.state_dict())
            for t in (g, e):
                t.set_lr(config.lr / 2)
    for batch in (b, b, b, a):
        losses.append(step("train_step", batch))
    for t in (g, e):
        t.load_state_dict(copy.deepcopy(saved))  # each its own tensors, as from a checkpoint
    for _ in range(2):
        losses.append(step("train_step", a))
    for _ in range(3):
        step("eval_step", a)
    state_err = []
    for (n, p), q in zip(g.model.named_parameters(), e.model.parameters()):
        state_err.append((rel_err(p, q), n))
        for k in ("exp_avg", "exp_avg_sq"):
            state_err.append((rel_err(g.optimizer.state[p][k], e.optimizer.state[q][k]), f"{n} {k}"))
    state_err.sort(reverse=True)
    if not state_err[0][0] <= MODEL_TOL:
        raise AssertionError(f"{label}: graphed and eager parameters or Adam moments apart: {state_err[:3]}")
    # each key by its kind and its node count
    capture_s = {f"{k[0]} N={next(shp[0] for n, shp, _ in k[-1][0] if n == K.NODE_MASK)}": v
                 for k, v in g._graphs.capture_seconds().items()}
    pool_mib = g._graphs.pool_bytes() / 2**20

    # host ms per step (synced wall) and the device's busy share, graphed against eager
    wall = {}
    for name, t in (("graphed", g), ("eager", e)):
        for _ in range(WARMUP):
            t.train_step(*a)
        torch.cuda.synchronize()
        ms = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            t.train_step(*a)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        wall[name] = ms
    # the kernels each profiled step ran on the card, by kind, against what
    # the counters added: a replay adds its capture's launches, so this is
    # what shows that the graph holds every kernel
    prof, in_trace = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, t in (("graphed", g), ("eager", e)):
            before = counts(fused_conv)
            ev, prof[name] = traced(lambda: t.train_step(*a), GRAPH_PROFILED_STEPS, Path(tmp),
                                    f"{name}_step", torch)
            counted = {k: (v - before[k]) / GRAPH_PROFILED_STEPS for k, v in counts(fused_conv).items()}
            in_trace[name] = {k: sum(x.get("cat") == "kernel" and is_kind(x["name"], k) for x in ev)
                              / GRAPH_PROFILED_STEPS for k in KERNEL_NAMES}
            if in_trace[name] != counted or counted != {k: convs for k in COUNTERS}:
                raise AssertionError(f"{label}: a profiled {name} step ran {in_trace[name]} kernels of each kind "
                                     f"on the card, counted {counted}, expected {convs} of each")
    print(f"[26 compiled steps, {label}] {card}: {GRAPH_STEPS} graphed train steps on batch A (N="
          f"{a[0][K.NODE_MASK].shape[0]}) against eager from the same state, lr halved after step "
          f"{GRAPH_LR_STEP}, then batch B (N={b[0][K.NODE_MASK].shape[0]}) x3 and A, then load_state_dict of "
          f"step {GRAPH_LR_STEP}'s state and 2 steps, then 3 eval steps: losses "
          + ", ".join(f"{x:.6f}" for x in losses)
          + f"; worst relative difference of a loss or metric sum {max(errs):.3e} (tol {GRAPH_LOSS_TOL}); "
          f"parameters and Adam moments worst {state_err[0][1]} {state_err[0][0]:.3e} (tol {MODEL_TOL}); "
          f"{replays} replays under set_sync_debug_mode('error'), launches exact ({convs} of each kernel per "
          f"step); kernels per profiled step in the trace, graphed {in_trace['graphed']}, eager "
          f"{in_trace['eager']}, each equal to the counters' step", flush=True)
    print(f"[26 step time, {label}] {card}: host ms per train step on batch A (synced wall, median and q1-q3 of "
          f"{REPS}): " + "; ".join(f"{n} {np.median(v):.4f} ({np.percentile(v, 25):.4f}-{np.percentile(v, 75):.4f})"
                                  for n, v in wall.items())
          + f"; under the profiler, per step of {GRAPH_PROFILED_STEPS}: "
          + "; ".join(f"{n}: {device_summary(st)}" for n, st in prof.items()), flush=True)
    print(f"[26 graph memory, {label}] {card}: the graphs' pools {pool_mib:.1f} MiB; capture s per key (kind, N): "
          + ", ".join(f"{k} {v:.3f}" for k, v in capture_s.items()), flush=True)
    return launched


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, metavar="DIR",
                    help="also profile the forward and the train step and write the traces to DIR")
    ap.add_argument("--cards", type=int, default=1, metavar="N",
                    help="N >= 2: run data and graph parallelism on N cards, a rank each under nccl, in "
                         "place of the one-card phases")
    args = ap.parse_args()
    n_cards = args.cards
    if n_cards < 1 or (n_cards > 1 and args.profile is not None):
        raise SystemExit("chip_smoke: --cards takes N >= 1, and --profile only with one card")

    # the run drives n_cards cards, cuda:0 ...: leave only the first visible ones visible
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", ",".join(str(i) for i in range(n_cards)))
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(visible.split(",")[:n_cards])
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    if torch.cuda.device_count() != n_cards:
        raise SystemExit(f"chip_smoke: {torch.cuda.device_count()} devices visible, expected {n_cards}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.kernels import _build
    from matten_tpu_torch.kernels import fused_conv, fused_tp
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.ops.scatter import scatter_sum
    from matten_tpu_torch.ops.spherical_harmonics import spherical_harmonics
    from matten_tpu_torch.predict import batch_to_device, predict
    from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    cards = [line.strip() for line in smi.splitlines()[:n_cards]]
    card = cards[0] if n_cards == 1 else f"{n_cards} x {cards[0]}"
    print("\n".join(cards))
    print(f"[1 env] card='{card}' torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]}", flush=True)

    # 2. build (once, before any rank starts)
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = (_build.build_dir() / "build.log").read_text().splitlines()
    ptxas = " | ".join(l.split("info    : ")[-1] for l in log if "Used" in l)
    print(f"[2 build] nvcc sm_90a built+loaded in {build_s:.2f} s; ptxas: {ptxas}", flush=True)

    if n_cards > 1:
        cards_phases(n_cards, dev, card, torch)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0

    # flagship batch, its targets and the production model
    structures, target_rows = draw_structures()  # the flagship batch
    data_np, targets_np = collate(structures, target_rows)
    data, targets = batch_to_device(data_np, dev, targets_np)
    model = create_scalar_tensor_model(HPARAMS, DATASET_HPARAMS, device=dev, seed=SEED).eval()
    convs = conv_layers(model)
    n_nodes = data[K.POSITIONS].shape[0]
    n_edges = data[K.EDGE_INDEX].shape[1]
    src, dst = data[K.EDGE_INDEX][0].contiguous(), data[K.EDGE_INDEX][1].contiguous()
    sh = spherical_harmonics(HPARAMS["irreps_edge_sh"], data[K.EDGE_VECTORS])
    sh = (sh * data[K.EDGE_MASK][:, None].float()).contiguous()
    print(f"[batch] {int(data_np[K.NODE_MASK].sum())} real nodes / N={n_nodes}, "
          f"{int(data_np[K.EDGE_MASK].sum())} real edges / E={n_edges}, "
          f"{int(data_np[K.GRAPH_MASK].sum())} graphs / G={data_np[K.GRAPH_MASK].shape[0]}; "
          f"targets {TARGET} {tuple(targets[TARGET].shape)}", flush=True)

    # 3. kernel parity at the 4 production layer plans, then N = 2600 with
    #    the last plan, then a skewed graph
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer_inputs, parity = [], []
    max_abs = {k: 0.0 for k in (*COUNTERS, *BF16_COUNTERS)}
    edges = fused_conv.edge_plan(src, dst, n_nodes, n_nodes, with_src_order=True)
    # at bf16 storage (phase 23) the direct launches take sh and w cast as
    # the wrappers cast them, and their differences count for the bf16 kernels
    st = fused_conv._stored

    def bf16_kind(kind):
        return kind + "_bf16" if fused_tp.get_kernel_in_dtype() == "bfloat16" else kind

    def check_forward(plan, x, w, sh_, src_, dst_, n_out, n_in=None, record=max_abs):
        n_in = n_out if n_in is None else n_in
        plan_e = fused_conv.edge_plan(src_, dst_, n_in, n_out,
                                      item_edges=fused_conv.item_edges_for((plan,), dev))
        with torch.inference_mode():
            out = fused_conv.fused_uvu_conv(plan, x, sh_, w, src_, dst_, n_out, plan_e)
            out2 = fused_conv.fused_uvu_conv(plan, x, sh_, w, src_, dst_, n_out, plan_e)
            ref = fused_conv.uvu_conv_reference(plan, x, sh_, w, src_, dst_, n_out)
            partial, item_ptr = fused_conv._launch_items(plan, x, st(sh_), st(w), plan_e)
            summed = fused_conv._launch_fwd_sum(partial, item_ptr, n_out)
            # the grid is a static bound on the items: launched on the count
            # read back here, K1 gives the same bits
            n_items = int(item_ptr[-1])
            partial_c, _ = fused_conv._launch_items(plan, x, st(sh_), st(w), plan_e, n_items=n_items)
            summed_c = fused_conv._launch_fwd_sum(partial_c, item_ptr, n_out)
            item_node = torch.repeat_interleave(
                torch.arange(n_out, device=dev), (item_ptr[1:] - item_ptr[:-1]).long())
            sum_ref = torch.zeros_like(summed).index_add_(0, item_node, partial[:n_items])
        torch.cuda.synchronize()
        rel, rel_sum = rel_err(out, ref), rel_err(summed, sum_ref)
        record[bf16_kind("fwd")] = max(record[bf16_kind("fwd")], float((out - ref).abs().max()))
        record["fwd_sum"] = max(record["fwd_sum"], float((summed - sum_ref).abs().max()))
        if not (rel <= KERNEL_TOL and rel_sum <= KERNEL_TOL):
            raise AssertionError(f"K1 or its partial-row sum disagrees with its plain version at "
                                 f"d1={plan.irreps_in1.dim}, N={n_out}: {rel}, {rel_sum} > {KERNEL_TOL}")
        if not (torch.equal(out, out2) and torch.equal(out, summed)):
            raise AssertionError(f"K1 is not bitwise reproducible at d1={plan.irreps_in1.dim}, N={n_out}")
        if not (n_items <= partial.shape[0] and torch.equal(partial[:n_items], partial_c)
                and torch.equal(summed, summed_c)):
            raise AssertionError(f"K1 on its bound of {partial.shape[0]} items is not bitwise K1 on the "
                                 f"{n_items} items counted, at d1={plan.irreps_in1.dim}, N={n_out}")
        return out, (f"{rel:.3e} (partial-row sum {rel_sum:.3e}; {n_items} items, a grid of "
                     f"{partial.shape[0]}, bitwise the counted grid's)")

    for conv in convs:
        plan = conv.uvu_plan
        x = torch.randn(n_nodes, plan.irreps_in1.dim, generator=gen, device=dev)
        w = torch.randn(n_edges, plan.weight_numel, generator=gen, device=dev)
        w = (w * data[K.EDGE_MASK][:, None].float()).contiguous()
        g = torch.randn(n_nodes, plan.irreps_out.dim, generator=gen, device=dev)
        layer_inputs.append((plan, x, w, g))
        parity.append(f"d1={plan.irreps_in1.dim} dw={plan.weight_numel} "
                      f"dout={plan.irreps_out.dim} paths={len(plan.instructions)}: "
                      + check_forward(plan, x, w, sh, src, dst, n_nodes)[1])
    plan = convs[-1].uvu_plan
    big_e = BIG_N * BIG_DEGREE
    gen_big = torch.Generator(device=dev).manual_seed(SEED + 1)
    big = dict(
        x=torch.randn(BIG_N, plan.irreps_in1.dim, generator=gen_big, device=dev),
        w=torch.randn(big_e, plan.weight_numel, generator=gen_big, device=dev),
        g=torch.randn(BIG_N, plan.irreps_out.dim, generator=gen_big, device=dev),
        sh=torch.randn(big_e, plan.irreps_in2.dim, generator=gen_big, device=dev),
        src=torch.randint(0, BIG_N, (big_e,), generator=gen_big, device=dev, dtype=torch.int32),
        dst=torch.sort(torch.randint(0, BIG_N, (big_e,), generator=gen_big, device=dev,
                                     dtype=torch.int32))[0],
    )
    parity.append(f"N={BIG_N} E={big_e} L3 plan: " + check_forward(
        plan, big["x"], big["w"], big["sh"], big["src"], big["dst"], BIG_N)[1])
    # skewed: one destination with SKEW_DEGREE edges, the first SKEW_EMPTY
    # destinations (but it) without edges; n_in != n_out
    skew_dst = torch.cat([torch.full((SKEW_DEGREE,), SKEW_EMPTY // 2, device=dev, dtype=torch.int32),
                          torch.randint(SKEW_EMPTY, n_nodes, (SKEW_REST,), generator=gen_big, device=dev,
                                        dtype=torch.int32)]).sort()[0]
    skew_e = SKEW_DEGREE + SKEW_REST
    skew_n_in = n_nodes + 7
    skew_out, txt = check_forward(
        plan, torch.randn(skew_n_in, plan.irreps_in1.dim, generator=gen_big, device=dev),
        torch.randn(skew_e, plan.weight_numel, generator=gen_big, device=dev),
        torch.randn(skew_e, plan.irreps_in2.dim, generator=gen_big, device=dev),
        torch.randint(0, skew_n_in, (skew_e,), generator=gen_big, device=dev, dtype=torch.int32),
        skew_dst, n_nodes, skew_n_in)
    empty = torch.ones(n_nodes, dtype=torch.bool, device=dev)
    empty[skew_dst.long()] = False
    n_empty = int(empty.sum())
    if n_empty < SKEW_EMPTY - 1 or not bool((skew_out[empty] == 0).all()):
        raise AssertionError(f"K1 on the skewed graph: {n_empty} destinations without edges, "
                             "their rows not all zero")
    parity.append(f"skewed, one destination of degree {SKEW_DEGREE}, {n_empty} without edges "
                  f"(rows 0), E={skew_e}, n_in={skew_n_in}, L3 plan: {txt}")
    print(f"[3 kernel parity] K1 max|d|/max|ref| (tol {KERNEL_TOL}), two runs bitwise equal: "
          + "; ".join(parity) + f"; max|d|={max_abs['fwd']:.3e}, partial-row sum vs index_add_ "
          f"{max_abs['fwd_sum']:.3e}", flush=True)

    # 4. backward kernel parity: the 4 plans, then N = 2600 with the last plan
    def check_backward(plan, x, w, g, sh_, src_, dst_, n_in, record=max_abs):
        with torch.no_grad():
            dxe, dw = fused_conv._launch_bwd_edges(plan, x, g, st(sh_), st(w),
                                                   fused_conv.edge_plan(src_, dst_, n_in, g.shape[0]))
            dx = fused_conv._launch_dx_sum(dxe, fused_conv.src_order(src_, n_in), n_in)
            dx2, dw2 = fused_conv.uvu_conv_bwd(plan, x, g, sh_, w, src_, dst_, n_in)
            dx3, dw3 = fused_conv.uvu_conv_bwd(plan, x, g, sh_, w, src_, dst_, n_in)
            dxe_ref = fused_conv.uvu_conv_dxe_reference(plan, g, st(sh_).float(), st(w).float(), dst_)
            dx_sum = torch.zeros_like(dx).index_add_(0, src_.long(), dxe)
            dx_ref, dw_ref = fused_conv.uvu_conv_bwd_reference(plan, x, g, sh_, w, src_, dst_, n_in)
        torch.cuda.synchronize()
        errs = []
        for kind, name, out, ref in ((bf16_kind("bwd"), "dw", dw, dw_ref), (bf16_kind("bwd"), "dxe", dxe, dxe_ref),
                                     ("dx_sum", "dx sum", dx, dx_sum),
                                     (None, "dx", dx2, dx_ref), (None, "dw", dw2, dw_ref)):
            rel = rel_err(out, ref)
            if kind is not None:
                record[kind] = max(record[kind], float((out - ref).abs().max()))
            errs.append(f"{name} {rel:.3e}")
            if not rel <= KERNEL_TOL:
                raise AssertionError(f"{name} of the backward kernels disagrees with its plain "
                                     f"version at d1={plan.irreps_in1.dim}, N={n_in}: {rel} > {KERNEL_TOL}")
        if not (torch.equal(dx2, dx3) and torch.equal(dw2, dw3) and torch.equal(dx, dx2)):
            raise AssertionError(f"the backward kernels are not bitwise reproducible at "
                                 f"d1={plan.irreps_in1.dim}, N={n_in}")
        return ", ".join(errs) + ", bitwise equal twice"

    bwd_parity = [f"L{i}: " + check_backward(plan, x, w, g, sh, src, dst, n_nodes)
                  for i, (plan, x, w, g) in enumerate(layer_inputs)]
    bwd_parity.append(f"N={BIG_N} E={big_e} L3 plan: " + check_backward(
        plan, big["x"], big["w"], big["g"], big["sh"], big["src"], big["dst"], BIG_N))
    del big
    torch.cuda.empty_cache()
    print(f"[4 backward kernel parity] max|d|/max|ref| (tol {KERNEL_TOL}): merged kernel dw and "
          "per-edge dx rows vs plain, segment sum vs index_add_ of the same rows, uvu_conv_bwd "
          "dx and dw vs the plain backward: " + "; ".join(bwd_parity)
          + f"; max|d| merged {max_abs['bwd']:.3e}, segment sum {max_abs['dx_sum']:.3e}",
          flush=True)

    # 5. model forward through K1 and through the plain conv
    real = data[K.GRAPH_MASK]

    def fwd():
        with torch.inference_mode():
            return model(data)

    def fwd_plain():
        with fused_conv.force_plain():
            return fwd()

    reset_counts(fused_conv)
    out_k = fwd()
    per_fwd = counts(fused_conv)
    out_p = fwd_plain()
    torch.cuda.synchronize()
    if per_fwd != {"fwd": len(convs), "fwd_sum": len(convs), "bwd": 0, "dx_sum": 0}:
        raise AssertionError(f"launches per forward {per_fwd}, expected {len(convs)} of K1's two")
    if counts(fused_conv) != per_fwd:
        raise AssertionError("the plain forward launched a kernel")
    if tuple(out_k.shape) != (real.shape[0], 21) or not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"model output {tuple(out_k.shape)} not finite [G, 21]")
    rel = float((out_k[real] - out_p[real]).abs().max() / out_p[real].abs().max())
    print(f"[5 model] out {tuple(out_k.shape)}, {int(real.sum())} real rows: "
          f"max|d|/max|ref| K1 vs plain = {rel:.3e} (tol {MODEL_TOL}); "
          f"launches per forward {per_fwd}", flush=True)
    if not rel <= MODEL_TOL:
        raise AssertionError(f"model through K1 disagrees with the plain path: {rel}")

    # 6. serving, the first main path, counted
    reset_counts(fused_conv)
    results = predict(structures + [si_structure()], model, batch_size=32, device=dev)
    torch.cuda.synchronize()
    served = counts(fused_conv)
    for i, r in enumerate(results):
        if r is None or r.shape != (3, 3, 3, 3) or not np.isfinite(r).all():
            raise AssertionError(f"predict() result {i} is not a finite [3,3,3,3] tensor")
    if served["fwd"] == 0 or served["fwd_sum"] == 0:
        raise AssertionError(f"predict() did not launch both of K1's kernels: {served}")
    si = results[-1]
    print(f"[6 serving] predict() on {len(results)} structures: all finite [3,3,3,3]; "
          f"launches {served}; Si C_1111={si[0, 0, 0, 0]:.6f}", flush=True)

    # 7. train gradients: one step through the kernels vs a deep copy under force_plain
    task = CanonicalRegressionTask(name=TARGET)
    config = TrainerConfig(lr=0.01)
    train_model = create_scalar_tensor_model(HPARAMS, DATASET_HPARAMS, device=dev, seed=SEED)
    trainer = Trainer(train_model, [task], config, device=dev)
    trainer_p = Trainer(copy.deepcopy(train_model), [task], config, device=dev)

    loss_k, grads_k = step_grads(trainer, data, targets)
    with fused_conv.force_plain():
        loss_p, grads_p = step_grads(trainer_p, data, targets)
    grad_err = sorted(((rel_err(grads_k[n], r), n) for n, r in grads_p.items()), reverse=True)
    print(f"[7 train gradients] loss {loss_k:.6f} through the kernels, {loss_p:.6f} plain; "
          f"{len(grad_err)} parameters, max|d|/max|ref| per parameter worst: "
          + ", ".join(f"{n} {e:.3e}" for e, n in grad_err[:3]) + f" (tol {MODEL_TOL})", flush=True)
    if not grad_err[0][0] <= MODEL_TOL:
        raise AssertionError(f"train-step gradients disagree with the plain path: {grad_err[0]}")
    # both models back to the same state: the gradient pass moved the running
    # statistics of each by its own batch statistics
    trainer_p.model.load_state_dict(trainer.model.state_dict())

    # 8. train step, the second main path, counted
    losses, trained = [], {k: 0 for k in COUNTERS}
    for _ in range(TRAIN_STEPS):
        reset_counts(fused_conv)
        loss, metric_sums = trainer.train_step(data, targets)
        losses.append(float(loss))
        step_counts = counts(fused_conv)
        if any(v != len(convs) for v in step_counts.values()):
            raise AssertionError(f"launches in one train step {step_counts}, expected "
                                 f"{len(convs)} of each kernel")
        trained = {k: trained[k] + v for k, v in step_counts.items()}
    s_err, n_err = (float(v) for v in metric_sums[TARGET])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    print(f"[8 train step] {TRAIN_STEPS} Adam steps (lr {config.lr}) of Trainer.train_step: "
          f"losses {', '.join(f'{l:.6f}' for l in losses)}; last MAE {s_err / n_err:.6f} over "
          f"{n_err:g} values; launches {trained} ({len(convs)} of each per step)", flush=True)

    # 9. timings (CUDA events, medians of interleaved runs)
    fwd_k, fwd_p = interleaved(fwd, fwd_plain, torch)

    def step_plain():
        with fused_conv.force_plain():
            trainer_p.train_step(data, targets)

    step_k, step_p = interleaved(lambda: trainer.train_step(data, targets), step_plain, torch)
    layer_ms = {k: [] for k in COUNTERS}
    bounds = {k: [] for k in COUNTERS}
    # index_add_ of the same rows: each segment sum's function in one call
    library_ms = {"fwd_sum": [], "dx_sum": []}
    src_long = src.long()
    item_node = torch.repeat_interleave(
        torch.arange(n_nodes, device=dev), (edges.item_ptr[1:] - edges.item_ptr[:-1]).long())
    sum_inputs = []  # for phase 10
    for plan, x, w, g in layer_inputs:
        with torch.no_grad():
            # as the model calls it: on the batch's edge plan
            k1 = functools.partial(fused_conv.fused_uvu_conv, plan, x, sh, w, src, dst, n_nodes, edges)
            layer_ms["fwd"].append(interleaved(
                k1, lambda: fused_conv.uvu_conv_reference(plan, x, sh, w, src, dst, n_nodes), torch))
            # as the train step launches it: src and dst checked by the edge plan
            layer_ms["bwd"].append(interleaved(
                lambda: fused_conv._launch_bwd_edges(plan, x, g, sh, w, edges),
                lambda: fused_conv.uvu_conv_bwd_reference(plan, x, g, sh, w, src, dst, n_nodes),
                torch,
            ))
            partial, _ = fused_conv._launch_items(plan, x, sh, w, edges)
            dxe, _ = fused_conv._launch_bwd_edges(plan, x, g, sh, w, edges, want_dw=False)
            # the kernel sums the partial rows as the model's K1 leaves them (its
            # grid's bound of rows); the plain sum and index_add_ take the real ones
            for kind, rows, idx, fn in (
                    ("fwd_sum", partial[:item_node.shape[0]], item_node, lambda: fused_conv._launch_fwd_sum(partial, edges.item_ptr, n_nodes)),
                    ("dx_sum", dxe, src_long, lambda: fused_conv._launch_dx_sum(dxe, edges.order, n_nodes))):
                layer_ms[kind].append(interleaved(fn, lambda: scatter_sum(rows, idx, n_nodes), torch))
                acc = torch.zeros(n_nodes, rows.shape[1], device=dev)
                library_ms[kind].append(interleaved(lambda: acc.index_add_(0, idx, rows), fn, torch)[0])
            sum_inputs.append((k1, partial, edges, item_node, dxe, src_long))
        for kind, (nbytes, flops) in kernel_work(plan, n_nodes, n_nodes, n_edges, int(edges.item_ptr[-1])).items():
            bounds[kind].append(bound_ms(nbytes, flops))

    # K1's item pass on its static grid against the grid of its counted items:
    # device ms per call over GRID_LOOP calls between two events, interleaved
    grid_ms = []
    with torch.no_grad():
        for plan, x, w, _ in layer_inputs:
            n_items = int(edges.items(fused_conv.launch_tiers(plan, dev)[0].edges)[0][-1])
            grid_ms.append(interleaved(
                lambda: [fused_conv._launch_items(plan, x, sh, w, edges) for _ in range(GRID_LOOP)],
                lambda: [fused_conv._launch_items(plan, x, sh, w, edges, n_items=n_items) for _ in range(GRID_LOOP)],
                torch))
    peak_fwd = (own_peak_mib(fwd, torch), own_peak_mib(fwd_plain, torch))
    peak_step = (own_peak_mib(lambda: trainer.train_step(data, targets), torch),
                 own_peak_mib(step_plain, torch))
    per_layer = "; ".join(
        f"{kind} " + " / ".join(f"{k:.4f} vs {p:.4f}" for k, p in layer_ms[kind])
        for kind in layer_ms)
    bound_txt = "; ".join(
        f"{kind} " + " / ".join(f"{b:.4f} ({by})" for b, by in bounds[kind]) for kind in bounds)
    print(f"[9 timings] {card}: flagship batch (32 crystals), median ms, kernel vs plain: "
          f"forward {fwd_k:.4f} vs {fwd_p:.4f}; train step {step_k:.4f} vs {step_p:.4f}; "
          f"per layer L0 / L1 / L2 / L3 (fwd: K1 with its partial-row sum vs the plain version; "
          f"bwd: the merged kernel vs the plain backward; fwd_sum, dx_sum: the segment sum vs "
          f"scatter_sum): {per_layer}; index_add_ of the same rows "
          + "; ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v) for k, v in library_ms.items())
          + f"; bound ms per layer: {bound_txt}; K1's item pass, ms per call over {GRID_LOOP} calls, on "
          f"its static grid ({edges.items(16)[1]} blocks) vs the counted grid ({int(edges.item_ptr[-1])}): "
          + " / ".join(f"{b / GRID_LOOP:.4f} vs {c / GRID_LOOP:.4f}" for b, c in grid_ms)
          + f"; peak memory MiB above the resident (the train step graphed, its pool resident): forward "
          f"{peak_fwd[0]:.1f} vs {peak_fwd[1]:.1f}, train step {peak_step[0]:.1f} vs {peak_step[1]:.1f}",
          flush=True)

    # 11-15. the per-atom NMR model, and both families served from disk
    nmr, nmr_trainer, nmr_batch = nmr_phases(dev, card, torch, check_forward, check_backward, model,
                                             structures, target_rows)

    # 16-17. both train scripts from data files, on the card
    fitted = fit_phases(fused_conv, torch, card)

    # 18-19. the variants configuration: its kernels and gradients, then its fit
    variants, variant_trainer, variant_batch = variant_phases(
        dev, card, torch, check_forward, check_backward, model, structures, target_rows, sh, src, dst)
    variants_fit = variants_fit_phase(fused_conv, torch, card)

    # 20-22. data and graph parallelism: 2 ranks on the card
    mesh_launched, mesh_max_abs = parallel_phases(dev, card, torch, structures, target_rows)

    # 23. bf16 storage of sh and w: parity, noise, counted runs, timings
    bf16_launched, bf16_ms, bf16_bounds = bf16_phase(
        dev, card, torch, check_forward, check_backward, layer_inputs, sh, src, dst, edges, model, trainer,
        data, targets, nmr_trainer, nmr_batch, layer_ms)

    # 24. the DEBUG-level model, the step timer and the profiler trace
    debug_phase(dev, card, torch, model, data)

    # 25. plans past production: their tiers, kernels, forward and steps
    wide_launched, wide_tiers, wide_errs, wide_ms, wide_plain_ms, wide_bounds = wide_phase(
        dev, card, torch, check_forward, check_backward, data, targets, src, dst)

    # 26. compiled steps: the train and eval steps as CUDA graph replays against eager,
    #     each family on its batch and on a second pad shape (half the crystals)
    nmr_structures, nmr_rows = draw_structures(seed=2, n_graphs=16, per_atom=True)
    graph_launched = {k: 0 for k in COUNTERS}
    for label, tr, a_batch, half in (
            ("flagship", trainer, (data, targets), collate(structures[:16], target_rows[:16])),
            ("NMR", nmr_trainer, nmr_batch, collate(nmr_structures[:8], nmr_rows[:8], NMR_TARGET, SI))):
        c = graph_phase(label, dev, card, torch, tr, (a_batch, batch_to_device(half[0], dev, half[1])))
        graph_launched = {k: graph_launched[k] + c[k] for k in COUNTERS}

    if args.profile is not None:
        print(profile_forward(model, fwd, data, args.profile, torch), flush=True)
        print(profile_train(trainer, (data, targets), args.profile, torch), flush=True)
        print(profile_sums(sum_inputs, args.profile / "sums", torch), flush=True)
        print(profile_train(nmr_trainer, nmr_batch, args.profile, torch, name="nmr_train"), flush=True)
        print(profile_train(variant_trainer, variant_batch, args.profile, torch, name="variants_train"), flush=True)

    sources = {"fwd": "matten_tpu_torch/kernels/csrc/fused_conv.cu",
               "fwd_sum": "matten_tpu_torch/kernels/csrc/segment_sum.cu",
               "bwd": "matten_tpu_torch/kernels/csrc/fused_conv_bwd.cu",
               "dx_sum": "matten_tpu_torch/kernels/csrc/segment_sum.cu"}
    replaces = {"fwd": "matten_tpu/kernels/fused_conv.py:1012",
                "fwd_sum": "matten_tpu/kernels/fused_conv.py:1012",
                "bwd": "matten_tpu/kernels/fused_conv.py:1118, :407 and :552",
                "dx_sum": "matten_tpu/kernels/fused_conv.py:1118 and :407"}
    names = {"fwd": "fused_uvu_conv_fwd (K1; ms with its partial-row sum)",
             "fwd_sum": "segment_sum (K1's partial rows into dst)",
             "bwd": "fused_uvu_conv_bwd (K2; K3 transposed, K4)",
             "dx_sum": "segment_sum (K2 and K3 dx into src)",
             "fwd_bf16": "fused_uvu_conv_fwd, bf16 sh and w (K1; ms with its partial-row sum)",
             "bwd_bf16": "fused_uvu_conv_bwd, bf16 sh and w (K2)"}
    library = {"fwd": None, "fwd_sum": sum(library_ms["fwd_sum"]), "bwd": None,
               "dx_sum": sum(library_ms["dx_sum"])}
    kernels = []
    for kind in COUNTERS:
        launched = (served[kind] + trained[kind] + nmr[kind] + fitted[kind] + variants[kind] + variants_fit[kind]
                    + mesh_launched[kind] + graph_launched[kind])
        if trained[kind] == 0:
            raise AssertionError(f"the train step never launched the {kind} kernel")
        kernels.append({
            "name": names[kind],
            "route": "cuda",
            "source": sources[kind],
            "replaces": replaces[kind],
            "launches": launched,
            "max_abs_err": max(max_abs[kind], mesh_max_abs[kind]),
            "ms": sum(k for k, _ in layer_ms[kind]),
            "plain_ms": sum(p for _, p in layer_ms[kind]),
            "bound_ms": sum(b for b, _ in bounds[kind]),
            "bound_by": bound_by(bounds[kind]),
            "library_ms": library[kind],
        })
    for kind in BF16_COUNTERS:
        base = kind.replace("_bf16", "")
        kernels.append({
            "name": names[kind],
            "route": "cuda",
            "source": sources[base],
            "replaces": "matten_tpu/kernels/fused_conv.py:1012" if base == "fwd"
                        else "matten_tpu/kernels/fused_conv.py:1118",
            "launches": bf16_launched[kind],
            "max_abs_err": max_abs[kind],
            "ms": sum(k for k, _ in bf16_ms[kind]),
            "plain_ms": sum(p for _, p in bf16_ms[kind]),
            "bound_ms": sum(b for b, _ in bf16_bounds[kind]),
            "bound_by": bound_by(bf16_bounds[kind]),
            "library_ms": None,
        })
    for kind in ("fwd", "bwd"):
        if wide_launched[kind] == 0:
            raise AssertionError(f"phase 25 never launched the {kind} kernel")
        kernels.append({
            "name": names[kind].split(" (")[0] + ", plans past production (phase 25: "
                    + ", ".join(WIDE_CONFIGS) + ")",
            "route": "cuda",
            "source": sources[kind],
            "replaces": replaces[kind],
            "launches": wide_launched[kind],
            "max_abs_err": wide_errs[kind],
            "ms": sum(wide_ms[kind]),
            "plain_ms": sum(wide_plain_ms[kind]),
            "bound_ms": sum(b for b, _ in wide_bounds[kind]),
            "bound_by": bound_by(wide_bounds[kind]),
            "library_ms": None,
            "tiers": {label: n for (k, label), n in sorted(wide_tiers.items()) if k == kind},
            "bf16_max_abs_err": wide_errs[kind + "_bf16"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
