"""Reproduce the open profiler fault on graphed mesh steps (ROADMAP §3).

    python3 profiler_fault.py

On a machine with 4 cards, starts 2-rank nccl worlds at once, a card
pair each, whose ranks run `chip_smoke.py`'s rank bodies:

- (e) `chip_smoke.mesh_rank` over PROBE_STEPS (dp 2x1 unprofiled, then
  edge and node 1x2) with only graphed `profile_trace` sessions from one
  mesh's to the next's, under each way of leaving CUPTI after a graph is
  freed: "after" (the port's: `StepGraphs.drop` frees, then
  `release_cupti` tears CUPTI down), "before" (torn down before the
  free), "kernel" (torn down by a session that runs a kernel) and
  "attached" (`TEARDOWN_CUPTI=0` in the ranks' environment: never torn
  down);
- the same with the GPU tests' cases (dp 2x1, edge, node, node_ring 1x2);
- (f) `chip_smoke.fit_probe_rank`, a fit's order of events.

Prints each world's outcome: what `chip_smoke.check_probe_steps` or
`check_fit_probe` found, with (f)'s sessions, or how the world ended and
where each rank was (its session lines and the faulting stack).
"""

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (e) as graph_probe's, and the GPU tests' nccl_pair cases
PAIR_STEPS = (("dp 2x1", 2, 1, "edge", "no_bn"), ("edge 1x2", 1, 2, "edge", "production"),
              ("node 1x2", 1, 2, "node", "production"), ("node_ring 1x2", 1, 2, "node_ring", "production"))


def release_with_kernel():
    """`utils.timing.release_cupti` whose teardown session runs a kernel."""
    import torch

    from matten_tpu_torch.utils import timing

    if torch.autograd._profiler_enabled():
        timing._cupti["dropped"] = True
        return
    if not timing._cupti["kept"]:
        return
    timing._cupti["kept"] = False
    if timing._sets_teardown():
        timing._set_teardown("1")
        with torch.profiler.profile(activities=timing._activities()):
            torch.ones(1 << 20, device="cuda").mul_(2)
            torch.cuda.synchronize()


def rank(rank, world_size, arg):
    """A rank: `chip_smoke`'s `target` on `job`, the release varied as
    `variant` says ("after" and "attached" run the port's code)."""
    import chip_smoke
    from matten_tpu_torch.train import graphs
    from matten_tpu_torch.utils import timing

    variant, target, job = arg
    if variant == "kernel":
        graphs.release_cupti = timing.release_cupti = release_with_kernel
    elif variant == "before":
        def drop(self, kind=None):
            kept = {k: g for k, g in self.graphs.items() if kind is not None and k[0] != kind}
            if len(kept) < len(self.graphs):
                timing.release_cupti()
            self.graphs = kept
        graphs.StepGraphs.drop = drop
    return getattr(chip_smoke, target)(rank, world_size, job)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        raise SystemExit("profiler_fault: needs 4 CUDA devices")
    import chip_smoke
    from matten_tpu_torch.kernels import _build
    from matten_tpu_torch.parallel.launch import start_ranks

    t0 = time.time()
    _build.load_library()  # once, before any rank starts
    structures, rows = chip_smoke.draw_structures()

    def jobs(specs):
        cases = chip_smoke.mesh_cases(specs, structures, rows, profile_all=False)
        cases = [dict(c, eager_profile=False) for c in cases]
        return cases, [{k: v for k, v in c.items() if k != "single"} for c in cases]

    e_cases, e_job = jobs(chip_smoke.PROBE_STEPS)
    p_cases, p_job = jobs(PAIR_STEPS)
    fit = jobs([chip_smoke.PROBE_FIT])[1][0]
    env = {"PYTHONPATH": str(ROOT), "PYTHONFAULTHANDLER": "1"}
    plan = [("(e), release after the free", "0,1", {}, ("after", "mesh_rank", e_job), e_cases),
            ("(e), release by a session with a kernel", "2,3", {}, ("kernel", "mesh_rank", e_job), e_cases),
            ("(f), release after the free", "0,1", {}, ("after", "fit_probe_rank", fit), None),
            ("the GPU tests' cases, release after the free", "2,3", {}, ("after", "mesh_rank", p_job), p_cases),
            ("(e), release before the free", "0,1", {}, ("before", "mesh_rank", e_job), e_cases),
            ("(e), CUPTI attached throughout", "2,3", {"TEARDOWN_CUPTI": "0"}, ("after", "mesh_rank", e_job),
             e_cases)]
    worlds = [(name, start_ranks("profiler_fault:rank", 2, arg, timeout_s=chip_smoke.MESH_TIMEOUT_S,
                                 threads=chip_smoke.MESH_THREADS,
                                 env=dict(env, CUDA_VISIBLE_DEVICES=cards, **extra), backend="nccl"), cases)
              for name, cards, extra, arg, cases in plan]
    for name, ranks, cases in worlds:
        with ranks:
            try:
                res = ranks.join()
            except RuntimeError as err:
                text = str(err)
                print(f"[{name}] {time.time() - t0:.1f} s: {text.splitlines()[0]}"
                      + (" (Segmentation fault)" if "Segmentation fault" in text else ""), flush=True)
                for line in text.splitlines():
                    if "session" in line or "Fatal" in line or "Error" in line or "File" in line:
                        print("    ", line[:240])
                continue
        if cases is None:
            print(f"[{name}] {time.time() - t0:.1f} s:", chip_smoke.check_fit_probe(res), flush=True)
            for k, v in res[0]["sessions"].items():
                print(f"    session {k}: {v}")
        else:
            print(f"[{name}] {time.time() - t0:.1f} s:", chip_smoke.check_probe_steps(cases, res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
