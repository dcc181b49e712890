"""Start the ranks of a local world as processes, each running one function.

    results = run_ranks("package.module:function", world_size=4, arg=...)

A small counterpart of torchrun for tests and smoke runs on one host:
every rank is a fresh interpreter (`python -m matten_tpu_torch.parallel.launch`,
never a fork) that joins a process group with a file store in a temporary
directory (no port to pick), calls `function(rank, world_size, arg)` and
hands back what it returns, pickled. The backend is gloo (CPU tensors, or
CUDA tensors of ranks that share a card) unless the caller names nccl:
then rank r runs on card r with `LOCAL_RANK=r`, as torchrun would start
it, and a world larger than the visible cards, or nccl without CUDA, is
refused; it never falls back to gloo. The whole world is joined
with a time limit: a rank that fails or outlives it fails the call, with
every rank that failed named and the ranks' stderr, and every rank still
running is killed. Train scripts
are launched with torchrun instead (`scripts/`).
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["run_ranks", "start_ranks", "Ranks"]

# after a rank fails, its peers get this long to end on their own before
# they are killed, so that a peer's failure is reported beside the first
FAIL_GRACE_S = 5.0


class Ranks:
    """A world of ranks started as processes (`start_ranks`). `join()`
    waits for them within the time limit and returns their results; leaving
    the `with` block kills whatever still runs and removes the files."""

    def __init__(self, target: str, world_size: int, arg: Any, timeout_s: float, threads: int,
                 env: Optional[Dict[str, str]], backend: str):
        if backend == "nccl":
            _check_cards(world_size)
        self.target, self.world_size, self.timeout_s = target, world_size, timeout_s
        self._tmp = tempfile.TemporaryDirectory(prefix="ranks-")
        self.dir = Path(self._tmp.name)
        with open(self.dir / "arg.pkl", "wb") as f:
            pickle.dump(arg, f)
        # OpenBLAS would start a thread per core in every rank, and ranks
        # that spin-wait on one another's cores take a hundred times longer
        child_env = {**os.environ, "OMP_NUM_THREADS": str(threads), "OPENBLAS_NUM_THREADS": str(threads),
                     **(env or {})}
        self._deadline = time.monotonic() + timeout_s
        self._procs = []
        for rank in range(world_size):
            cmd = [sys.executable, "-m", "matten_tpu_torch.parallel.launch", target, str(rank),
                   str(world_size), str(threads), str(self.dir), backend]
            rank_env = dict(child_env, LOCAL_RANK=str(rank)) if backend == "nccl" else child_env
            with open(self.dir / f"rank{rank}.err", "w") as err:
                self._procs.append(subprocess.Popen(cmd, env=rank_env, stdout=err, stderr=subprocess.STDOUT))

    def join(self) -> List[Any]:
        """The ranks' results in rank order. A failed world raises, naming
        every rank that exited with a non-zero code, each with its code, in
        the order seen (after the first, its peers get FAIL_GRACE_S to end
        on their own), and the ranks still running, which are killed."""
        failed, pending, end = {}, list(range(self.world_size)), self._deadline
        while pending:
            for rank in list(pending):
                rc = self._procs[rank].poll()
                if rc is not None:
                    pending.remove(rank)
                    if rc != 0:
                        if not failed:
                            end = min(end, time.monotonic() + FAIL_GRACE_S)
                        failed[rank] = rc
            if pending:
                if time.monotonic() > end:
                    break
                time.sleep(0.05)
        self._kill()
        if failed or pending:
            what = [f"rank {r} exited with {rc}" for r, rc in failed.items()]
            if pending:
                what.append(f"ranks {pending} killed {FAIL_GRACE_S:.0f} s after" if failed
                            else f"ranks {pending} still running after {self.timeout_s:.0f} s")
            logs = "\n".join(f"--- rank {r} ---\n" + (self.dir / f"rank{r}.err").read_text()[-4000:]
                             for r in range(self.world_size))
            raise RuntimeError(f"{self.target}: {', '.join(what)}\n{logs}")
        results = []
        for rank in range(self.world_size):
            with open(self.dir / f"rank{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results

    def _kill(self) -> None:
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self._kill()
        self._tmp.cleanup()


def _check_cards(world_size: int) -> None:
    """An nccl world takes one visible card per rank."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs CUDA, and torch.cuda.is_available() is false: "
                           "start the ranks with backend='gloo' on the CPU")
    cards = torch.cuda.device_count()
    if world_size > cards:
        raise ValueError(f"a world of {world_size} nccl ranks needs {world_size} cards, one per rank; "
                         f"{cards} visible")


def start_ranks(
    target: str,
    world_size: int,
    arg: Any = None,
    timeout_s: float = 300.0,
    threads: int = 1,
    env: Optional[Dict[str, str]] = None,
    backend: str = "gloo",
) -> Ranks:
    """Start `target` ("module:function") on `world_size` ranks and return
    at once. `arg` is pickled to each rank; `env` is added to the ranks'
    environment (e.g. a PYTHONPATH that finds the target's module); each
    rank runs `threads` torch threads and `threads` BLAS threads
    (`OMP_NUM_THREADS`, `OPENBLAS_NUM_THREADS`, unless `env` names them),
    since ranks that each spin one per core starve one another; the ranks
    must end within `timeout_s`. `backend` "nccl" puts rank r on card r (module
    docstring)."""
    return Ranks(target, world_size, arg, timeout_s, threads, env, backend)


def run_ranks(target: str, world_size: int, arg: Any = None, **kwargs) -> List[Any]:
    """`start_ranks`, then their results in rank order."""
    with start_ranks(target, world_size, arg, **kwargs) as ranks:
        return ranks.join()


def _rank_main(target: str, rank: int, world_size: int, threads: int, tmp: Path, backend: str) -> int:
    import torch
    import torch.distributed as dist

    from matten_tpu_torch.parallel.distributed import initialize_distributed
    from matten_tpu_torch.train.graphs import live_graphs

    torch.set_num_threads(threads)
    try:
        with open(tmp / "arg.pkl", "rb") as f:
            arg = pickle.load(f)
        initialize_distributed(backend=backend, init_method=f"file://{tmp / 'store'}", world_size=world_size,
                               rank=rank, device=torch.device("cuda", rank) if backend == "nccl" else None)
        module, fn = target.split(":")
        result = getattr(importlib.import_module(module), fn)(rank, world_size, arg)
        with open(tmp / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        # NCCL destroys a communicator only once every graph that captured
        # its operations is gone: the target frees its step graphs
        # (`Trainer.free_graphs`), never the garbage collector
        live = live_graphs()
        if live:
            raise RuntimeError(f"{target} left {live} step graph(s) alive; free them before the group goes")
        dist.destroy_process_group()
    except Exception:  # the rank's boundary: report and fail the world
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    _target, _rank, _world, _threads, _tmp, _backend = sys.argv[1:7]
    sys.exit(_rank_main(_target, int(_rank), int(_world), int(_threads), Path(_tmp), _backend))
