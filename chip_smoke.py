#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is not 0):
  1. environment: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc builds the port's kernels from the sources in this checkout;
  3. kernel parity: the fused uvu conv kernel (K1) against its plain PyTorch
     version at the 4 conv-layer plans of the production elasticity model,
     on the flagship batch's real edges, seeded random x and w;
  4. model: the production ScalarTensorModel (seeded random weights) on the
     flagship batch through K1 and through the plain conv; exactly 4 K1
     launches per forward;
  5. serving: `matten_tpu_torch.predict.predict` on the 32 flagship crystals
     plus Si; every result a finite [3, 3, 3, 3] tensor; the K1 launch
     count of this run is what the kernels line reports;
  6. timings with CUDA events: forward latency and per-layer conv time,
     kernel against plain, interleaved.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. There is no CPU path: without CUDA the
script fails. The run uses one card: only the first visible device is
left visible.

    python3 chip_smoke.py --profile DIR

adds phase 7, where the forward's time goes: host wall per forward,
per backbone layer, and a torch.profiler trace of 5 forwards (device ops,
device busy time, host launches, host and device time of the species
FCTPs, the radial MLP and the K1 wrapper), written to DIR.

The flagship batch is the one `bench.py::build_batch` draws
(np.random.default_rng(0), 32 crystals of 4-12 atoms over 5 species,
r_cut 5.0), collated with `pad_spec_for` + `collate_graphs`.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time
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

# K1 vs plain: f32 with another summation order (per-edge CG contraction
# and per-node sums vs einsum + index_add), relative to max |ref|
KERNEL_TOL = 1e-5
# whole model: the same difference carried through 4 convs, gates and BN
MODEL_TOL = 1e-4
SEED = 0
WARMUP, REPS = 3, 20


def flagship_structures(n_graphs=32, atoms_lo=4, atoms_hi=12):
    """The 32 crystals of `bench.py::build_batch`, drawn in the same order
    (the per-graph target draw advances the generator too)."""
    from matten_tpu.data.structure import Structure

    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(atoms_lo, atoms_hi + 1))
        out.append(
            Structure(
                lattice=np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1,
                frac_coords=rng.uniform(0, 1, size=(n, 3)),
                atomic_numbers=rng.choice(SPECIES_5, size=n),
            )
        )
        rng.normal(size=(1, 21))  # bench.py's target draw
    return out


def si_structure():
    from matten_tpu.data.structure import Structure

    return Structure(
        lattice=np.array([[0, 2.73, 2.73], [2.73, 0, 2.73], [2.73, 2.73, 0]]),
        frac_coords=[[0, 0, 0], [0.25, 0.25, 0.25]],
        atomic_numbers=[14, 14],
    )


def collate(structures):
    from matten_tpu.data.graph import CrystalGraph, collate_graphs, pad_spec_for
    from matten_tpu_torch.nn.embedding import atomic_number_map

    graphs = [CrystalGraph.from_structure(s, r_cut=5.0) for s in structures]
    data, _ = collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(SPECIES_5))
    return data


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


PROFILED_FORWARDS = 5
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_forward(model, fwd, data, out_dir, torch):
    """Phase 7: where the time of one forward goes. Returns the line to print.

    Device numbers come from the exported trace's "kernel", "gpu_memcpy"
    and "gpu_memset" events only; the "gpu_user_annotation" ranges that
    the labels below add on the device side span kernels and are kept out
    of every count and sum.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_FORWARDS):
                fwd()
            torch.cuda.synchronize()
    finally:
        for (obj, attr, _), fn in zip(patched, saved):
            setattr(obj, attr, fn)
    ka = prof.key_averages()
    by_device = ("self_device_time_total" if hasattr(ka[0], "self_device_time_total")
                 else "self_cuda_time_total")
    (out_dir / "profile_table.txt").write_text(
        ka.table(sort_by=by_device, row_limit=40) + "\n\n"
        + ka.table(sort_by="cpu_time_total", row_limit=40))
    trace = out_dir / "forward_trace.json"
    prof.export_chrome_trace(str(trace))
    ev = json.loads(trace.read_text())
    ev = [e for e in (ev["traceEvents"] if isinstance(ev, dict) else ev) if e.get("ph") == "X"]

    nf = PROFILED_FORWARDS
    dev_ops = sorted((e for e in ev if e.get("cat") in DEVICE_OPS), key=lambda e: e["ts"])
    counts = {c: sum(e["cat"] == c for e in dev_ops) / nf for c in DEVICE_OPS}
    busy, end = 0.0, -1.0  # union of device intervals, us
    for e in dev_ops:
        s, t = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    span = (dev_ops[-1]["ts"] + dev_ops[-1]["dur"] - dev_ops[0]["ts"]) / nf / 1e3
    busy_ms = busy / nf / 1e3
    launches = sum(e.get("cat") == "cuda_runtime" and e["name"].startswith("cudaLaunchKernel")
                   for e in ev) / nf
    k1 = [e["dur"] / 1e3 for e in dev_ops if "fused_uvu_conv_fwd" in e["name"]]
    k1_layers = [float(np.mean(k1[i::4])) for i in range(4)]

    per_label = []
    for _, _, name in patched:
        host = [e["dur"] for e in ev if e.get("cat") == "user_annotation" and e["name"] == name]
        dev = 0.0
        for g in (e for e in ev if e.get("cat") == "gpu_user_annotation" and e["name"] == name):
            dev += sum(e["dur"] for e in dev_ops if g["ts"] <= e["ts"] < g["ts"] + g["dur"])
        n = len(host)
        per_label.append(f"{name} {n / nf:g} calls/fwd, host {sum(host) / n / 1e3:.4f} ms/call, "
                         f"device {dev / n / 1e3:.4f} ms/call")

    return (
        f"[7 profile] host wall per forward (synced, unprofiled) ms: median "
        f"{np.median(wall):.4f} q1 {np.percentile(wall, 25):.4f} q3 {np.percentile(wall, 75):.4f}; "
        "per layer ms (synced): " + ", ".join(f"{n} {t:.4f}" for n, t in zip(names, layer_ms))
        + f"; under the profiler, per forward: {counts['kernel']:g} kernels, "
        f"{counts['gpu_memcpy']:g} memcpys, {counts['gpu_memset']:g} memsets, "
        f"{launches:g} cudaLaunchKernel calls, device busy {busy_ms:.4f} ms of a "
        f"{span:.4f} ms span ({100 * busy_ms / span:.1f}%); K1 kernel ms per layer "
        + " / ".join(f"{t:.4f}" for t in k1_layers) + "; " + "; ".join(per_label)
        + f"; trace and tables in {out_dir}"
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, metavar="DIR",
                    help="also profile the forward and write the trace to DIR")
    args = ap.parse_args()

    # the run drives one card, cuda:0: leave only the first visible one visible
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    if torch.cuda.device_count() != 1:
        raise SystemExit(f"chip_smoke: {torch.cuda.device_count()} devices visible, expected 1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from matten_tpu.data import keys as K
    from matten_tpu_torch.kernels import _build
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.ops.spherical_harmonics import spherical_harmonics
    from matten_tpu_torch.predict import batch_to_device, predict

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card)
    print(f"[1 env] card='{card}' torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = (_build.build_dir() / "build.log").read_text().splitlines()
    ptxas = " | ".join(l.split("info    : ")[-1] for l in log if "Used" in l)
    print(f"[2 build] nvcc sm_90a built+loaded in {build_s:.2f} s; ptxas: {ptxas}", flush=True)

    # flagship batch and the production model
    structures = flagship_structures()
    data_np = collate(structures)
    data = batch_to_device(data_np, dev)
    model = create_scalar_tensor_model(HPARAMS, DATASET_HPARAMS, device=dev, seed=SEED).eval()
    convs = conv_layers(model)
    n_nodes = data[K.POSITIONS].shape[0]
    n_edges = data[K.EDGE_INDEX].shape[1]
    src, dst = data[K.EDGE_INDEX][0].contiguous(), data[K.EDGE_INDEX][1].contiguous()
    sh = spherical_harmonics(HPARAMS["irreps_edge_sh"], data[K.EDGE_VECTORS])
    sh = (sh * data[K.EDGE_MASK][:, None].float()).contiguous()
    print(f"[batch] {int(data_np[K.NODE_MASK].sum())} real nodes / N={n_nodes}, "
          f"{int(data_np[K.EDGE_MASK].sum())} real edges / E={n_edges}, "
          f"{int(data_np[K.GRAPH_MASK].sum())} graphs / G={data_np[K.GRAPH_MASK].shape[0]}", flush=True)

    # 3. kernel parity at the 4 production layer plans
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer_inputs, parity, max_abs = [], [], 0.0
    for conv in convs:
        plan = conv.uvu_plan
        x = torch.randn(n_nodes, plan.irreps_in1.dim, generator=gen, device=dev)
        w = torch.randn(n_edges, plan.weight_numel, generator=gen, device=dev)
        w = (w * data[K.EDGE_MASK][:, None].float()).contiguous()
        layer_inputs.append((plan, x, w))
        with torch.inference_mode():
            out = fused_conv.fused_uvu_conv(plan, x, sh, w, src, dst, n_nodes)
            ref = fused_conv.uvu_conv_reference(plan, x, sh, w, src, dst, n_nodes)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        max_abs = max(max_abs, err)
        parity.append(f"d1={plan.irreps_in1.dim} dw={plan.weight_numel} "
                      f"dout={plan.irreps_out.dim} paths={len(plan.instructions)}: {rel:.3e}")
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"K1 disagrees with its plain version: {parity[-1]} > {KERNEL_TOL}")
    print(f"[3 kernel parity] max|d|/max|ref| per layer (tol {KERNEL_TOL}): "
          + "; ".join(parity) + f"; max|d|={max_abs:.3e}", flush=True)

    # 4. model forward through K1 and through the plain conv
    real = data[K.GRAPH_MASK]

    def fwd():
        with torch.inference_mode():
            return model(data)

    def fwd_plain():
        with fused_conv.force_plain():
            return fwd()

    before = fused_conv.launches
    out_k = fwd()
    per_fwd = fused_conv.launches - before
    out_p = fwd_plain()
    torch.cuda.synchronize()
    if per_fwd != len(convs):
        raise AssertionError(f"{per_fwd} K1 launches per forward, expected {len(convs)}")
    if fused_conv.launches - before != per_fwd:
        raise AssertionError("the plain forward launched K1")
    if tuple(out_k.shape) != (real.shape[0], 21) or not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"model output {tuple(out_k.shape)} not finite [G, 21]")
    rel = float((out_k[real] - out_p[real]).abs().max() / out_p[real].abs().max())
    print(f"[4 model] out {tuple(out_k.shape)}, {int(real.sum())} real rows: "
          f"max|d|/max|ref| K1 vs plain = {rel:.3e} (tol {MODEL_TOL}); "
          f"{per_fwd} K1 launches per forward", flush=True)
    if not rel <= MODEL_TOL:
        raise AssertionError(f"model through K1 disagrees with the plain path: {rel}")

    # 5. serving: the main path, counted
    fused_conv.launches = 0
    results = predict(structures + [si_structure()], model, batch_size=32, device=dev)
    torch.cuda.synchronize()
    served_launches = fused_conv.launches
    for i, r in enumerate(results):
        if r is None or r.shape != (3, 3, 3, 3) or not np.isfinite(r).all():
            raise AssertionError(f"predict() result {i} is not a finite [3,3,3,3] tensor")
    if served_launches == 0:
        raise AssertionError("predict() never launched K1")
    si = results[-1]
    print(f"[5 serving] predict() on {len(results)} structures: all finite [3,3,3,3]; "
          f"K1 launches {served_launches}; Si C_1111={si[0, 0, 0, 0]:.6f}", flush=True)

    # 6. timings (CUDA events, medians of interleaved runs)
    fwd_k, fwd_p = interleaved(fwd, fwd_plain, torch)
    layer_ms = []
    for plan, x, w in layer_inputs:
        with torch.inference_mode():
            k_ms, p_ms = interleaved(
                lambda: fused_conv.fused_uvu_conv(plan, x, sh, w, src, dst, n_nodes),
                lambda: fused_conv.uvu_conv_reference(plan, x, sh, w, src, dst, n_nodes),
                torch,
            )
        layer_ms.append((k_ms, p_ms))
    torch.cuda.reset_peak_memory_stats()
    fwd()
    torch.cuda.synchronize()
    peak_k = torch.cuda.max_memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    fwd_plain()
    torch.cuda.synchronize()
    peak_p = torch.cuda.max_memory_allocated() / 2**20
    layers = "; ".join(f"L{i} {k:.4f} vs {p:.4f}" for i, (k, p) in enumerate(layer_ms))
    print(f"[6 timings] {card}: forward of the flagship batch (32 crystals) median "
          f"{fwd_k:.4f} ms through K1, {fwd_p:.4f} ms plain; per-layer conv ms K1 vs plain: "
          f"{layers}; peak memory per forward {peak_k:.1f} MiB K1, {peak_p:.1f} MiB plain",
          flush=True)

    if args.profile is not None:
        print(profile_forward(model, fwd, data, args.profile, torch), flush=True)

    kernels = [{
        "name": "fused_uvu_conv_fwd (K1)",
        "route": "cuda",
        "source": "matten_tpu_torch/kernels/csrc/fused_conv.cu",
        "replaces": "matten_tpu/kernels/fused_conv.py:1012",
        "launches": served_launches,
        "max_abs_err": max_abs,
        "ms": sum(k for k, _ in layer_ms),
        "plain_ms": sum(p for _, p in layer_ms),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
