#!/usr/bin/env python3
"""Where the merged conv backward kernel's time goes, on one NVIDIA GPU.

    python3 conv_bwd_phases.py

Builds variants of `matten_tpu_torch/kernels/csrc/fused_conv_bwd.cu` that
skip phases of the kernel, and times each, by CUDA events over 20 launches
after 3 of warm-up, at the 4 conv-layer plans of the production elasticity
model on the flagship batch (as `chip_smoke.py` draws them):

  full      the kernel as it ships;
  no_tasks  without the lanes' tasks (staging and the t_e contraction);
  no_t      without the t_e contraction (staging and the tasks);
  prologue  without both: the edge arrays, sh, and the w and g copies.

So full - no_tasks is about the tasks' share and full - no_t the t_e
contraction's. Variants that skip a phase compute garbage; only their time
is read. Prints one line per layer; needs a CUDA device and nvcc.
"""

import ctypes
import hashlib
import subprocess
import sys

import torch

import chip_smoke as cs

TASKS = "  for (int k = __ldg(a.warp_ptr + warp); k < k_end; ++k) {"
T_E = "  contract_te<BWD_THREADS, ANY_L>("
VARIANTS = {
    "full": [],
    "no_tasks": [(TASKS, TASKS.replace("k < k_end;", "k < k_end && a.n_t < 0;"))],
    "no_t": [(T_E, "  if (a.n_edges < 0) contract_te<BWD_THREADS, ANY_L>(")],
}
VARIANTS["prologue"] = VARIANTS["no_tasks"] + VARIANTS["no_t"]


def build(_build):
    """{variant: ctypes library}, nvcc run for all variants at once."""
    source = (_build._CSRC / "fused_conv_bwd.cu").read_text()
    common = (_build._CSRC / "fused_conv_common.cuh").read_bytes()
    out = _build.BUILD_ROOT / ("phases-" + hashlib.sha256(source.encode() + common).hexdigest()[:16])
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"conv_bwd_phases: the kernel source no longer has {old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC), "-shared",
               "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"conv_bwd_phases: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.fused_uvu_conv_bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("conv_bwd_phases: needs a CUDA device")
    from matten_tpu_torch.data import keys as K
    from matten_tpu_torch.kernels import _build
    from matten_tpu_torch.kernels import fused_conv as fc
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.ops.spherical_harmonics import spherical_harmonics
    from matten_tpu_torch.predict import batch_to_device

    libs = build(_build)
    dev = torch.device("cuda", 0)
    data_np, targets_np = cs.collate(*cs.draw_structures())
    data, _ = batch_to_device(data_np, dev, targets_np)
    model = create_scalar_tensor_model(cs.HPARAMS, cs.DATASET_HPARAMS, device=dev, seed=cs.SEED)
    n, e = data[K.POSITIONS].shape[0], data[K.EDGE_INDEX].shape[1]
    src, dst = data[K.EDGE_INDEX][0].contiguous(), data[K.EDGE_INDEX][1].contiguous()
    sh = spherical_harmonics(cs.HPARAMS["irreps_edge_sh"], data[K.EDGE_VECTORS])
    sh = (sh * data[K.EDGE_MASK][:, None].float()).contiguous()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"{card}: merged conv backward, flagship batch N={n} E={e}, us per launch", flush=True)
    for li, conv in enumerate(cs.conv_layers(model)):
        plan = conv.uvu_plan
        d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
        x = torch.randn(n, d1, generator=gen, device=dev)
        w = torch.randn(e, dw, generator=gen, device=dev)
        g = torch.randn(n, dout, generator=gen, device=dev)
        t_meta = fc._tables_on(plan, dev)[0]
        tier = fc.launch_tiers(plan, dev, 4)[1]
        tt = fc._tile_tables_on(plan, dev, fc.FWD_ITEM_EDGES, tier.edges)
        dxe, dw_out = torch.empty(e, d1, device=dev), torch.empty(e, dw, device=dev)
        ptrs = [x, g, sh, w, src, dst, t_meta, tt.cg_t, tt.t_sh, tt.sh_src, tt.groups, tt.paths,
                tt.path_pw, tt.tasks, tt.warp_ptr, dw_out, dxe]
        times = []
        for name, lib in libs.items():
            def launch():
                rc = lib.fused_uvu_conv_bwd(
                    *(t.data_ptr() for t in ptrs), e, d1, d2, len(tt.sh_src), dw, dout, t_meta.shape[0], 4,
                    tier.edges, int(tier.stage_w), tier.g_slots, int(tt.any_l), fc.BWD_WARPS,
                    torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise SystemExit(f"conv_bwd_phases: {name} launch failed (cudaError {rc})")
            cs.cuda_ms(lambda: [launch() for _ in range(cs.WARMUP)], torch)
            us = 1e3 * cs.cuda_ms(lambda: [launch() for _ in range(cs.REPS)], torch) / cs.REPS
            times.append(f"{name} {us:.1f}")
        print(f"L{li} (d1 {d1}, dw {dw}, dout {dout}): " + ", ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
