"""Reproduce the profiler faults on graphed mesh steps (ROADMAP §3) and
check their repairs.

    python3 profiler_fault.py [LOG_DIR]

On a machine with 4 cards, starts 2-rank nccl worlds (and two 1-rank
ones), at most WAVE at a time, spread over the card pairs, whose ranks
run `chip_smoke.py`'s rank bodies. Most are probe (e),
`chip_smoke.mesh_rank` over PROBE_STEPS (dp 2x1 unprofiled, then edge
and node 1x2, each with its `mesh_twins`) with only graphed
`profile_trace` sessions from one mesh's to the next's, changed in one
thing. The fault: a rank died on a segmentation fault
inside libcupti, called from `cuGraphLaunch` (`CUDAGraph.replay`), at
node's first or second graphed session, once step graphs had been freed
after a session. Its repair: `StepGraphs.drop` runs the trainer's eager
eval forward under the profiler before it frees graphs, inside the
running session or, once a session has ended, in one of its own
(`utils.timing.traced_before_free`). Where the user has set
TEARDOWN_CUPTI (or torch.compile's pair, with DISABLE_CUPTI_LAZY_REINIT),
a session after such a free is refused with a RuntimeError instead
(`utils.timing._Profile`).

The plan's worlds that must give exact sums: (e) on two card pairs, (e)
with only node's twins (the smallest order that faulted), with the GPU
tests' cases (dp 2x1, edge, node, node_ring 1x2), (f) (`chip_smoke.
fit_probe_rank`, a fit's order on one mesh), (d'') (`chip_smoke.
graph_probe_rank`'s (d') with its node mesh made after its first
session), (r5f) ((e) with `set_lr` freeing each profiled case's train
graphs inside its last graphed session, as a profiled fit's plateau step
does) and (f) with `set_lr` inside its session 2. The worlds that must
be refused on every rank, with no segmentation fault: (e) with
`TEARDOWN_CUPTI=0` set by the user, and with torch.compile's pair.
Reported beside them: (e0), (e) on `drop` without the repair (no forward
before a free: the fault), without node's twins and with a session of
eager eval steps between cases; and ROADMAP §3's open fault, a session
that traced nothing after another trainer's graphs were freed inside a
session: (r5f') ((e) with only node's twins, made and freed inside a
session) and, on one card each (a 1-rank world, `chip_smoke.
session_probe_rank`), (s1) a second trainer's captures, `set_lr` and
`free_graphs` inside a session and (s3) its `free_graphs` alone inside
one, each followed by sessions of the first trainer's graphs.

Prints each world's outcome: what `chip_smoke.check_probe_steps` (or
`check_fit_probe`, `check_session_probe`) found, or how the world ended and where (the session
lines, the faulting thread's native frames and the Python stack); with
LOG_DIR, a failed world's whole rank logs are copied there. Exits 1 when
a world did not end as it must.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the GPU tests' nccl_pair cases
PAIR_STEPS = (("dp 2x1", 2, 1, "edge", "no_bn"), ("edge 1x2", 1, 2, "edge", "production"),
              ("node 1x2", 1, 2, "node", "production"), ("node_ring 1x2", 1, 2, "node_ring", "production"))
WAVE = 12  # worlds at a time: the host's cores are shared by every rank
REFUSED = "profiler session refused"  # the start of `utils.timing._refusal`'s message
ATTACHED = {"TEARDOWN_CUPTI": "0"}
COMPILE_PAIR = {"TEARDOWN_CUPTI": "0", "DISABLE_CUPTI_LAZY_REINIT": "1"}

# a SIGSEGV handler that prints the faulting thread's native frames to
# stderr, then hands the signal back to the handler it replaced (Python's
# faulthandler, which prints every Python thread's stack)
NATIVE_STACK_C = r"""
#include <execinfo.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <unistd.h>
static struct sigaction prev;
static void on_fault(int sig, siginfo_t *info, void *ctx) {
    void *frames[64];
    char line[96];
    int n = backtrace(frames, 64);
    int k = snprintf(line, sizeof line, "native stack of the faulting thread (address %p):\n", info->si_addr);
    write(2, line, k);
    backtrace_symbols_fd(frames, n, 2);
    sigaction(sig, &prev, NULL);  /* the fault repeats under the handler before */
}
void install_native_stack(void) {
    void *warm[2];
    struct sigaction sa;
    backtrace(warm, 2);  /* loads the unwinder outside the handler */
    memset(&sa, 0, sizeof sa);
    sa.sa_sigaction = on_fault;
    sa.sa_flags = SA_SIGINFO | SA_ONSTACK;
    sigaction(SIGSEGV, &sa, &prev);
}
"""

def build_native_stack(out_dir):
    """NATIVE_STACK_C built into `out_dir`, or None without a C compiler."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None
    src, lib = Path(out_dir) / "native_stack.c", Path(out_dir) / "native_stack.so"
    src.write_text(NATIVE_STACK_C)
    proc = subprocess.run([cc, "-shared", "-fPIC", "-O1", "-o", str(lib), str(src)], capture_output=True, text=True)
    return str(lib) if proc.returncode == 0 else None


def dropping(free):
    """A `StepGraphs.drop` that calls `free(self, kept, freed)` where the
    graphs of `kind` are to be freed (`kept` the rest)."""
    def drop(self, kind=None):
        kept = {k: g for k, g in self.graphs.items() if kind is not None and k[0] != kind}
        freed = [g for k, g in self.graphs.items() if k not in kept]
        if freed:
            free(self, kept, freed)
    return drop


def patch(changes):
    """Apply `changes` to this rank's process, before anything runs."""
    import chip_smoke
    from matten_tpu_torch.train import graphs
    from matten_tpu_torch.utils import timing

    def unrepaired(self, kept, freed):
        self.graphs = kept
        freed.clear()
        graphs.release_cupti()

    if "unrepaired" in changes:  # no forward before the free
        graphs.StepGraphs.drop = dropping(unrepaired)
    if "eval_session" in changes:
        profiled = chip_smoke.profiled_steps

        def eager_steps(step, logdir, rank, fused_conv, torch, label, inside=None):
            if not label.endswith(" eager"):
                return profiled(step, logdir, rank, fused_conv, torch, label, inside)
            trainer, data, targets = step.__defaults__
            with timing.profile_trace(str(logdir)):
                for _ in range(chip_smoke.MESH_PROFILED_STEPS + 1):
                    trainer.eval_step(data, targets)
                torch.cuda.synchronize()
            return None
        chip_smoke.profiled_steps = eager_steps


def rank(rank, world_size, arg):
    """A rank: `chip_smoke`'s `target` on `job`, with `changes`. A refused
    session ends the rank at once with exit code 1 (its step graphs, which
    hold NCCL communicators, are left to the process's end)."""
    import chip_smoke

    changes, target, job = arg
    if os.environ.get("NATIVE_STACK_LIB"):
        ctypes.CDLL(os.environ["NATIVE_STACK_LIB"]).install_native_stack()
    patch(changes)
    try:
        out = getattr(chip_smoke, target)(rank, world_size, job)
    except RuntimeError as err:
        if not str(err).startswith(REFUSED):
            raise
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    if "eval_session" in changes:  # no eager train steps profiled
        for res in out.values():
            res["profiles"].pop("eager", None)
    return out


def report(text):
    """The lines of a failed world's report worth printing: the session
    lines, and the first faulting rank's native frames and the stack of
    the thread in a graph launch (or the last errors)."""
    lines = text.splitlines()
    out = [line for line in lines if " session" in line]
    if "native stack" in text:
        i = next(i for i, line in enumerate(lines) if "native stack" in line)
        out += lines[i:i + 14]
    if "Fatal Python error" in text:
        i = next((i for i, line in enumerate(lines) if "in replay" in line),
                 next(i for i, line in enumerate(lines) if "Fatal Python error" in line))
        out += lines[i:i + 6]
    else:
        out += [line for line in lines if "Error" in line][-3:]
    return out


def plans(job):
    """The worlds: (name, extra environment, (changes, target, job), cases
    to check, how it must end: "exact" sums, "refused" on every rank, or
    None where it is reported as found). `job(specs, **case_keys)` gives
    (cases, rank job)."""
    import chip_smoke

    e = job(chip_smoke.PROBE_STEPS)
    node_twins = dict(twins=("node 1x2",))
    fit = job([chip_smoke.PROBE_FIT])[1][0]
    d2 = dict(ops=("all_reduce", "all_gather"), sessions=1, before=True, size=16, late_mesh=True)

    def world(name, changes, cases, env=None, expect=None):
        return name, env or {}, (changes, "mesh_rank", cases[1]), cases[0], expect

    def fit_world(name, changes, lr_in_session, expect=None):
        return name, {}, (changes, "fit_probe_rank", dict(fit, lr_in_session=lr_in_session)), None, expect

    r5f = job(chip_smoke.PROBE_STEPS, lr_in_session=True)
    r5f2 = job(chip_smoke.PROBE_STEPS, twins_in_session=True, **node_twins)
    return [world("(e) as the probe runs it", (), e, expect="exact"),
            world("(e) again", (), e, expect="exact"),
            world("(e) with twins only in node 1x2", (), job(chip_smoke.PROBE_STEPS, **node_twins), expect="exact"),
            world("(e) with the GPU tests' cases", (), job(PAIR_STEPS), expect="exact"),
            fit_world("(f) a fit's order", (), False, "exact"),
            ("(d'') (d') with its node mesh made after its first session", {}, ((), "graph_probe_rank", d2),
             None, "exact"),
            world("(r5f) (e) with set_lr inside each case's last graphed session", (), r5f, expect="exact"),
            fit_world("(f) with set_lr inside session 2", (), True, "exact"),
            world("(e) with TEARDOWN_CUPTI=0 set by the user", (), e, ATTACHED, "refused"),
            world("(e) with torch.compile's pair set by the user", (), e, COMPILE_PAIR, "refused"),
            # ROADMAP §3's open fault: a session after another trainer's frees inside a session
            world("(r5f') (e), node's twins made and freed inside a session", (), r5f2),
            ("(s1) one card: a second trainer's captures, set_lr and free_graphs inside a session", {},
             ((), "session_probe_rank", {"inside": chip_smoke.SESSION_PROBE_PHASES}), None, None),
            ("(s3) one card: a second trainer's free_graphs inside a session", {},
             ((), "session_probe_rank", {"inside": ("free",)}), None, None),
            world("(e0) (e) on drop without the repair", ("unrepaired",), e),
            world("(e0) without node's twins", ("unrepaired",), job(chip_smoke.PROBE_STEPS,
                                                                       twins=("dp 2x1", "edge 1x2"))),
            world("(e0) with a session of eager eval steps between cases", ("unrepaired", "eval_session"),
                  job(chip_smoke.PROBE_STEPS, eager_profile=True))]


def refused_on_every_rank(ranks):
    """Whether every rank's log ends in the refusal, with no segmentation
    fault in any."""
    logs = [(ranks.dir / f"rank{r}.err").read_text() for r in range(ranks.world_size)]
    return all(f"RuntimeError: {REFUSED}" in log and "Segmentation fault" not in log and "Fatal Python error" not in log
               for log in logs)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        raise SystemExit("profiler_fault: needs 4 CUDA devices")
    import chip_smoke
    from matten_tpu_torch.kernels import _build
    from matten_tpu_torch.parallel.launch import start_ranks

    log_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    t0 = time.time()
    _build.load_library()  # once, before any rank starts
    structures, rows = chip_smoke.draw_structures()

    def job(specs, eager_profile=False, twins=None, **keys):
        cases = [dict(c, eager_profile=eager_profile, twins=twins is None or c["name"] in twins, **keys)
                 for c in chip_smoke.mesh_cases(specs, structures, rows, profile_all=False)]
        return cases, [{k: v for k, v in c.items() if k != "single"} for c in cases]

    plan = plans(job)
    env = {"PYTHONPATH": str(ROOT), "PYTHONFAULTHANDLER": "1"}
    tmp = tempfile.TemporaryDirectory()
    native = build_native_stack(tmp.name)
    if native is not None:
        env["NATIVE_STACK_LIB"] = native
    pairs = ("0,1", "2,3", "0,2", "1,3", "0,3", "1,2")

    def start(i):
        name, extra, arg, _, _ = plan[i]
        size = 1 if arg[1] == "session_probe_rank" else 2
        return start_ranks("profiler_fault:rank", size, arg, timeout_s=chip_smoke.MESH_TIMEOUT_S,
                           threads=chip_smoke.MESH_THREADS,
                           env=dict(env, CUDA_VISIBLE_DEVICES=pairs[i % len(pairs)][:size * 2 - 1], **extra),
                           backend="nccl")

    worlds = [start(i) for i in range(min(WAVE, len(plan)))]
    failed = []
    for i, (name, _, (_, target, _), cases, expect) in enumerate(plan):
        ranks = worlds[i]
        with ranks:
            try:
                res = ranks.join()
            except RuntimeError as err:
                text = str(err)
                refused = refused_on_every_rank(ranks)
                if log_dir is not None and not (refused and expect == "refused"):  # the ranks' whole logs
                    log_dir.mkdir(parents=True, exist_ok=True)
                    for r in range(ranks.world_size):
                        shutil.copy(ranks.dir / f"rank{r}.err", log_dir / f"{name[:40]}-rank{r}.txt")
                print(f"[{name}] {time.time() - t0:.1f} s: {text.splitlines()[0]}"
                      + (" (Segmentation fault)" if "Segmentation fault" in text else "")
                      + (" (refused on every rank)" if refused else ""), flush=True)
                for line in report(text):
                    print("    ", line[:200])
                res = None
        if i + WAVE < len(plan):
            worlds.append(start(i + WAVE))
        if res is None:
            failed += [name] if expect == "exact" or (expect == "refused" and not refused) else []
            continue
        if target == "graph_probe_rank":
            found = ("exact sums" if all(all(r["exact"]) for r in res)
                     and all(k > 0 for r in res for k in r["nccl_in_trace"]) else res)
        elif target == "session_probe_rank":
            found = chip_smoke.check_session_probe(res)
        elif target == "fit_probe_rank":
            found, beside = chip_smoke.check_fit_probe(res)
            found = f"{found}; {beside}"
        else:
            found = chip_smoke.check_probe_steps(cases, res)
        print(f"[{name}] {time.time() - t0:.1f} s: every rank alive; {found}", flush=True)
        if (expect == "exact" and not found.startswith("exact sums")) or expect == "refused":
            failed.append(name)
    print(f"profiler_fault: {len(plan)} worlds in {time.time() - t0:.1f} s; of those that must give exact sums "
          f"or be refused, not as they must: {failed or 'none'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
