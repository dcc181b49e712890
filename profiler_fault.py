"""Reproduce the profiler fault on graphed mesh steps (ROADMAP §3), check
its repair, and rerun the bisection that found the cause.

    python3 profiler_fault.py [--bisect] [LOG_DIR]

On a machine with 4 cards, starts 2-rank nccl worlds at once, spread over
the card pairs, whose ranks run `chip_smoke.py`'s rank bodies. Most are
probe (e), `chip_smoke.mesh_rank` over PROBE_STEPS (dp 2x1 unprofiled,
then edge and node 1x2, each with its `mesh_twins`) with only graphed
`profile_trace` sessions from one mesh's to the next's, changed in one
thing. The fault: a rank died on a segmentation fault inside libcupti,
called from `cuGraphLaunch` (`CUDAGraph.replay`), at node's first or
second graphed session. Its repair: `StepGraphs.drop` runs the trainer's
eager eval forward under the profiler before it frees graphs, once a
session has run (`utils.timing.traced_before_free`).

The default plan checks the repair: (e) on two card pairs, (e) with only
node's twins (the smallest order that faulted), with the GPU tests'
cases (dp 2x1, edge, node, node_ring 1x2), (f) (`chip_smoke.
fit_probe_rank`, a fit's order on one mesh) and (d'') (`chip_smoke.
graph_probe_rank`'s (d') with its node mesh made after its first
session), which must give exact sums; beside them, reported as found,
(e) with `TEARDOWN_CUPTI=0` set by the user, and (e0), (e) on `drop`
without the repair (no forward before a free: the fault), without node's
twins and with a session of eager eval steps between cases.

`--bisect` reruns the bisection's variants instead, each on `drop`
without the repair unless said: (e1) every mesh made at the rank's start; (e2) node
on edge's process groups; (e3) the conv's plain versions in the graphs;
(e4) no twins; (e5) / (e6) one eager all-reduce per nccl group inside /
after the release's teardown session; (e7) unprofiled eager steps between
cases; (e8) `NCCL_GRAPH_REGISTER=0`; (e9) a session of eager train steps
between cases; (e10) of eager eval steps; (e11) (e9) with
`TEARDOWN_CUPTI=0`; (e12) twins only in node; (e13) twins only in dp and
edge; (r1) kernels that set their shared memory attribute only when it
grows; (r2) / (r3) the conv kernels run eagerly at each session's start /
in the release's session; (r4) no step graph freed before the rank's end;
(r5) graphs freed inside a session, each ending with a teardown; (r6)
graphs freed inside a session with CUPTI attached throughout; (r7) the
port's repair.

Prints each world's outcome: what `chip_smoke.check_probe_steps` (or
`check_fit_probe`) found, or how the world ended and where (the session
lines, the faulting thread's native frames and the Python stack); with
LOG_DIR, a failed world's whole rank logs are copied there. Exits 1 when
a world that must give exact sums did not.
"""

import contextlib
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the GPU tests' nccl_pair cases
PAIR_STEPS = (("dp 2x1", 2, 1, "edge", "no_bn"), ("edge 1x2", 1, 2, "edge", "production"),
              ("node 1x2", 1, 2, "node", "production"), ("node_ring 1x2", 1, 2, "node_ring", "production"))

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

# (r1)'s sources: each launch sets its kernel's dynamic shared memory
# attribute only when it grows (per device), so no capture sets it
ATTR_ONCE_DIR = ROOT / "matten_tpu_torch" / "_build" / "attr-once-src"
SET_ATTR = re.compile(r"cudaError_t err = cudaFuncSetAttribute\(\s*(\w+<[^>]*>), "
                      r"cudaFuncAttributeMaxDynamicSharedMemorySize, \(int\)smem\);")
# (r2) and (r3): the kernel checks' arguments of the rank's case, and the
# graphs (r4) keeps alive until the rank's end
TOUCH, PARKED = [], []


def build_native_stack(out_dir):
    """NATIVE_STACK_C built into `out_dir`, or None without a C compiler."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None
    src, lib = Path(out_dir) / "native_stack.c", Path(out_dir) / "native_stack.so"
    src.write_text(NATIVE_STACK_C)
    proc = subprocess.run([cc, "-shared", "-fPIC", "-O1", "-o", str(lib), str(src)], capture_output=True, text=True)
    return str(lib) if proc.returncode == 0 else None


def write_attr_once_sources():
    from matten_tpu_torch.kernels import _build

    ATTR_ONCE_DIR.mkdir(parents=True, exist_ok=True)
    for src in _build._sources():
        text = SET_ATTR.sub(
            lambda m: ("static int set_smem[64] = {0};\n  int dev = 0;\n  cudaGetDevice(&dev);\n"
                       "  cudaError_t err = cudaSuccess;\n  if ((int)smem > set_smem[dev]) {\n"
                       f"    err = cudaFuncSetAttribute({m.group(1)}, cudaFuncAttributeMaxDynamicSharedMemorySize, "
                       "(int)smem);\n    if (err == cudaSuccess) set_smem[dev] = (int)smem;\n  }"),
            src.read_text())
        (ATTR_ONCE_DIR / src.name).write_text(text)


@contextlib.contextmanager
def attr_once_sources():
    """`_build` on (r1)'s sources."""
    from matten_tpu_torch.kernels import _build

    csrc = _build._CSRC
    _build._CSRC = ATTR_ONCE_DIR
    try:
        yield
    finally:
        _build._CSRC = csrc


def nccl_groups():
    """Every nccl process group of this rank, in the order of creation."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    return [pg for pg in distributed_c10d._world.pg_map if dist.get_backend(pg) == "nccl"]


def all_reduce_each_group():
    import torch
    import torch.distributed as dist

    for pg in nccl_groups():
        dist.all_reduce(torch.ones(1, device="cuda"), group=pg)
    torch.cuda.synchronize()


def touch():
    """The conv kernels against their plain versions at the rank's plans,
    untimed (`chip_smoke.shard_kernels`)."""
    import torch

    import chip_smoke

    chip_smoke._shard_kernels(*TOUCH[-1], timed=False)
    torch.cuda.synchronize()


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
    import torch

    import chip_smoke
    import matten_tpu_torch.parallel as parallel
    from matten_tpu_torch.train import graphs
    from matten_tpu_torch.utils import timing

    def release_with(work, in_session):
        """`release_cupti` running `work` inside its teardown
        session or after it."""
        def release():
            if torch.autograd._profiler_enabled():
                timing._cupti["dropped"] = True
                return
            if not timing._cupti["kept"]:
                return
            timing._cupti["kept"] = False
            if timing._sets_teardown():
                timing._set_teardown("1")
                with torch.profiler.profile(activities=timing._activities()):
                    if in_session:
                        work()
            if not in_session:
                work()
        graphs.release_cupti = timing.release_cupti = release

    def unrepaired(self, kept, freed):
        self.graphs = kept
        freed.clear()
        graphs.release_cupti()

    if "unrepaired" in changes:  # no forward before the free
        graphs.StepGraphs.drop = dropping(unrepaired)
    if "mesh_at_start" in changes or "reuse_groups" in changes:
        make_mesh, made = parallel.make_mesh, {}

        def premade(n_data, n_graph, mode):
            key = (n_data, n_graph) if "reuse_groups" in changes else (n_data, n_graph, mode)
            if key not in made:
                made[key] = make_mesh(n_data, n_graph, mode)
            return dataclasses.replace(made[key], mode=mode)
        if "mesh_at_start" in changes:
            for spec in chip_smoke.PROBE_STEPS:
                premade(*spec[1:4])
        parallel.make_mesh = premade
    if "plain" in changes:
        from matten_tpu_torch.kernels import fused_tp

        fused_tp.set_tp_impl("xla")
        step = chip_smoke.graphed_step
        chip_smoke.graphed_step = lambda label, g, e, kind, batch, want, torch: step(
            label, g, e, kind, batch, {k: 0 for k in want}, torch)
    if "no_twins" in changes:
        chip_smoke.mesh_twins = lambda *args: None
    if "allreduce_in_release" in changes or "allreduce_after_release" in changes:
        release_with(all_reduce_each_group, "allreduce_in_release" in changes)
    if "unprofiled_eager" in changes or "eval_session" in changes:
        profiled = chip_smoke.profiled_steps

        def eager_steps(step, logdir, rank, fused_conv, torch, label):
            if not label.endswith(" eager"):
                return profiled(step, logdir, rank, fused_conv, torch, label)
            trainer, data, targets = step.__defaults__
            with timing.profile_trace(str(logdir)) if "eval_session" in changes else contextlib.nullcontext():
                for _ in range(chip_smoke.MESH_PROFILED_STEPS + 1):
                    trainer.eval_step(data, targets) if "eval_session" in changes else step()
                torch.cuda.synchronize()
            return None
        chip_smoke.profiled_steps = eager_steps
    if "attr_once" in changes:
        attr_once_sources().__enter__()  # for the rank's whole life
    if "touch_start" in changes or "touch_release" in changes:
        chip_smoke._shard_kernels = chip_smoke.shard_kernels

        def remembered(*args, **kwargs):
            TOUCH[:] = [args]
            return chip_smoke._shard_kernels(*args, **kwargs)
        chip_smoke.shard_kernels = remembered
    if "touch_start" in changes:
        start = timing._Profile.start

        def start_and_touch(self):
            start(self)
            if TOUCH:
                touch()
        timing._Profile.start = start_and_touch
    if "touch_release" in changes:
        release_with(touch, True)
    if "keep" in changes:
        def park(self, kept, freed):
            PARKED.extend(freed)
            unrepaired(self, kept, freed)
        graphs.StepGraphs.drop = dropping(park)
    if "free_in_session" in changes or "free_active" in changes:
        started = []
        start = timing._Profile.start

        def start_and_mark(self):
            started.append(True)
            start(self)
        timing._Profile.start = start_and_mark

        def in_session(self, kept, freed):
            if not started or torch.autograd._profiler_enabled():
                return unrepaired(self, kept, freed)
            if "free_in_session" in changes:
                timing._cupti["kept"] = False
                timing._set_teardown("1")
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=timing._activities()):
                self.graphs = kept
                freed.clear()
                torch.cuda.synchronize()
        graphs.StepGraphs.drop = dropping(in_session)


def rank(rank, world_size, arg):
    """A rank: `chip_smoke`'s `target` on `job`, with `changes`."""
    import chip_smoke

    changes, target, job = arg
    if os.environ.get("NATIVE_STACK_LIB"):
        ctypes.CDLL(os.environ["NATIVE_STACK_LIB"]).install_native_stack()
    patch(changes)
    out = getattr(chip_smoke, target)(rank, world_size, job)
    PARKED.clear()  # before the launcher counts the graphs alive
    if "unprofiled_eager" in changes or "eval_session" in changes:  # no eager train steps profiled
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
    """The default plan and the bisection's: (name, extra environment,
    (changes, target, job), cases to check, whether its sums must be
    exact) per world. `job(specs, **case_keys)` gives (cases, rank job)."""
    import chip_smoke

    e = job(chip_smoke.PROBE_STEPS)
    eager = job(chip_smoke.PROBE_STEPS, eager_profile=True)
    node_twins = job(chip_smoke.PROBE_STEPS, twins=("node 1x2",))
    no_node_twins = job(chip_smoke.PROBE_STEPS, twins=("dp 2x1", "edge 1x2"))
    fit = job([chip_smoke.PROBE_FIT])[1][0]
    d2 = dict(ops=("all_reduce", "all_gather"), sessions=1, before=True, size=16, late_mesh=True)
    attached = {"TEARDOWN_CUPTI": "0"}

    def world(name, changes, cases, env=None, exact=False):
        return name, env or {}, (changes, "mesh_rank", cases[1]), cases[0], exact

    check = [world("(e) as the probe runs it", (), e, exact=True),
             world("(e) again", (), e, exact=True),
             world("(e) with twins only in node 1x2", (), node_twins, exact=True),
             world("(e) with the GPU tests' cases", (), job(PAIR_STEPS), exact=True),
             ("(f) a fit's order", {}, ((), "fit_probe_rank", fit), None, True),
             ("(d'') (d') with its node mesh made after its first session", {}, ((), "graph_probe_rank", d2),
              None, True),
             world("(e) with TEARDOWN_CUPTI=0 set by the user", (), e, attached),
             world("(e0) (e) on drop without the repair", ("unrepaired",), e),
             world("(e0) without node's twins", ("unrepaired",), no_node_twins),
             world("(e0) with a session of eager eval steps between cases", ("unrepaired", "eval_session"), eager)]
    bisect = [world("(e) on drop without the repair", ("unrepaired",), e),
              world("(e1) every mesh made at the rank's start", ("unrepaired", "mesh_at_start"), e),
              world("(e2) node 1x2 on edge 1x2's groups", ("unrepaired", "reuse_groups"), e),
              world("(e3) the conv's plain versions in the graphs", ("unrepaired", "plain"), e),
              world("(e4) no twins", ("unrepaired", "no_twins"), e),
              world("(e5) an all-reduce per nccl group in the teardown session", ("unrepaired", "allreduce_in_release"),
                    e),
              world("(e6) an all-reduce per nccl group after the teardown", ("unrepaired", "allreduce_after_release"),
                    e),
              world("(e7) eager steps between cases, unprofiled", ("unrepaired", "unprofiled_eager"), eager),
              world("(e8) NCCL_GRAPH_REGISTER=0", ("unrepaired",), e, {"NCCL_GRAPH_REGISTER": "0"}),
              world("(e9) a session of eager train steps between cases", ("unrepaired",), eager),
              world("(e10) a session of eager eval steps between cases", ("unrepaired", "eval_session"), eager),
              world("(e11) (e9) with TEARDOWN_CUPTI=0", ("unrepaired",), eager, attached),
              world("(e12) twins only in node 1x2", ("unrepaired",), node_twins),
              world("(e13) twins only in dp 2x1 and edge 1x2", ("unrepaired",), no_node_twins),
              world("(r1) kernels that set their shared memory attribute when it grows", ("unrepaired", "attr_once"), e),
              world("(r2) the conv kernels run eagerly at each session's start", ("unrepaired", "touch_start"), e),
              world("(r3) the conv kernels run eagerly in the release's session", ("unrepaired", "touch_release"), e),
              world("(r4) no step graph freed before the rank's end", ("keep",), e),
              world("(r5) graphs freed inside a session ending with a teardown", ("free_in_session",), e),
              world("(r6) graphs freed inside a session, CUPTI attached throughout", ("free_active",), e, attached),
              world("(r7) the port's repair", (), e)]
    return check, bisect


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        raise SystemExit("profiler_fault: needs 4 CUDA devices")
    import chip_smoke
    from matten_tpu_torch.kernels import _build
    from matten_tpu_torch.parallel.launch import start_ranks

    args = sys.argv[1:]
    bisect = "--bisect" in args
    log_dir = next((Path(a) for a in args if a != "--bisect"), None)
    t0 = time.time()
    _build.load_library()  # once, before any rank starts
    if bisect:
        write_attr_once_sources()
        with attr_once_sources():
            _build.build()
    structures, rows = chip_smoke.draw_structures()

    def job(specs, eager_profile=False, twins=None):
        cases = [dict(c, eager_profile=eager_profile, twins=twins is None or c["name"] in twins)
                 for c in chip_smoke.mesh_cases(specs, structures, rows, profile_all=False)]
        return cases, [{k: v for k, v in c.items() if k != "single"} for c in cases]

    plan = plans(job)[1 if bisect else 0]
    env = {"PYTHONPATH": str(ROOT), "PYTHONFAULTHANDLER": "1"}
    tmp = tempfile.TemporaryDirectory()
    native = build_native_stack(tmp.name)
    if native is not None:
        env["NATIVE_STACK_LIB"] = native
    pairs = ("0,1", "2,3", "0,2", "1,3", "0,3", "1,2")
    worlds = [(name, arg, cases, exact,
               start_ranks("profiler_fault:rank", 2, arg, timeout_s=chip_smoke.MESH_TIMEOUT_S,
                           threads=chip_smoke.MESH_THREADS,
                           env=dict(env, CUDA_VISIBLE_DEVICES=pairs[i % len(pairs)], **extra), backend="nccl"))
              for i, (name, extra, arg, cases, exact) in enumerate(plan)]
    failed = []
    for name, (_, target, _), cases, exact, ranks in worlds:
        with ranks:
            try:
                res = ranks.join()
            except RuntimeError as err:
                text = str(err)
                if log_dir is not None:  # the ranks' whole logs
                    log_dir.mkdir(parents=True, exist_ok=True)
                    for r in range(2):
                        shutil.copy(ranks.dir / f"rank{r}.err", log_dir / f"{name[:40]}-rank{r}.txt")
                print(f"[{name}] {time.time() - t0:.1f} s: {text.splitlines()[0]}"
                      + (" (Segmentation fault)" if "Segmentation fault" in text else ""), flush=True)
                for line in report(text):
                    print("    ", line[:200])
                failed += [name] if exact else []
                continue
        if target == "graph_probe_rank":
            found = ("exact sums" if all(all(r["exact"]) for r in res)
                     and all(k > 0 for r in res for k in r["nccl_in_trace"]) else res)
        elif target == "fit_probe_rank":
            found = chip_smoke.check_fit_probe(res)[0]
        else:
            found = chip_smoke.check_probe_steps(cases, res)
        print(f"[{name}] {time.time() - t0:.1f} s: every rank alive; {found}", flush=True)
        if found != "exact sums" and exact:
            failed.append(name)
    print(f"profiler_fault: {len(plan)} worlds in {time.time() - t0:.1f} s; of those that must give exact sums, "
          f"not: {failed or 'none'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
