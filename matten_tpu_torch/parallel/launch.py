"""Start the ranks of a local world as processes, each running one function.

    results = run_ranks("package.module:function", world_size=4, arg=...)

A small counterpart of torchrun for tests and smoke runs on one host:
every rank is a fresh interpreter (`python -m matten_tpu_torch.parallel.launch`,
never a fork) that joins a gloo process group (CPU tensors, or CUDA
tensors of ranks that share a card) with a file store in a temporary
directory (no port to pick), calls `function(rank, world_size, arg)` and
hands back what it returns, pickled. The whole world is joined
with a time limit: a rank that fails or outlives it fails the call, with
the ranks' stderr, and every rank still running is killed. Train scripts
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


class Ranks:
    """A world of ranks started as processes (`start_ranks`). `join()`
    waits for them within the time limit and returns their results; leaving
    the `with` block kills whatever still runs and removes the files."""

    def __init__(self, target: str, world_size: int, arg: Any, timeout_s: float, threads: int,
                 env: Optional[Dict[str, str]]):
        self.target, self.world_size, self.timeout_s = target, world_size, timeout_s
        self._tmp = tempfile.TemporaryDirectory(prefix="ranks-")
        self.dir = Path(self._tmp.name)
        with open(self.dir / "arg.pkl", "wb") as f:
            pickle.dump(arg, f)
        child_env = {**os.environ, **(env or {})}
        self._deadline = time.monotonic() + timeout_s
        self._procs = []
        for rank in range(world_size):
            cmd = [sys.executable, "-m", "matten_tpu_torch.parallel.launch", target, str(rank),
                   str(world_size), str(threads), str(self.dir)]
            with open(self.dir / f"rank{rank}.err", "w") as err:
                self._procs.append(subprocess.Popen(cmd, env=child_env, stdout=err, stderr=subprocess.STDOUT))

    def join(self) -> List[Any]:
        failed, pending = None, list(range(self.world_size))
        while pending and failed is None:
            for rank in list(pending):
                rc = self._procs[rank].poll()
                if rc is not None:
                    pending.remove(rank)
                    if rc != 0:
                        failed = f"rank {rank} exited with {rc}"
            if pending and failed is None:
                if time.monotonic() > self._deadline:
                    failed = f"ranks {pending} still running after {self.timeout_s:.0f} s"
                time.sleep(0.05)
        self._kill()
        if failed is not None:
            logs = "\n".join(f"--- rank {r} ---\n" + (self.dir / f"rank{r}.err").read_text()[-4000:]
                             for r in range(self.world_size))
            raise RuntimeError(f"{self.target}: {failed}\n{logs}")
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


def start_ranks(
    target: str,
    world_size: int,
    arg: Any = None,
    timeout_s: float = 300.0,
    threads: int = 1,
    env: Optional[Dict[str, str]] = None,
) -> Ranks:
    """Start `target` ("module:function") on `world_size` ranks and return
    at once. `arg` is pickled to each rank; `env` is added to the ranks'
    environment (e.g. a PYTHONPATH that finds the target's module, or
    OPENBLAS_NUM_THREADS); each rank runs `threads` torch threads, since
    ranks that each spin one per core starve one another; the ranks must
    end within `timeout_s`."""
    return Ranks(target, world_size, arg, timeout_s, threads, env)


def run_ranks(target: str, world_size: int, arg: Any = None, **kwargs) -> List[Any]:
    """`start_ranks`, then their results in rank order."""
    with start_ranks(target, world_size, arg, **kwargs) as ranks:
        return ranks.join()


def _rank_main(target: str, rank: int, world_size: int, threads: int, tmp: Path) -> int:
    import torch
    import torch.distributed as dist

    from matten_tpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(threads)
    try:
        with open(tmp / "arg.pkl", "rb") as f:
            arg = pickle.load(f)
        initialize_distributed(backend="gloo", init_method=f"file://{tmp / 'store'}",
                               world_size=world_size, rank=rank)
        module, fn = target.split(":")
        result = getattr(importlib.import_module(module), fn)(rank, world_size, arg)
        with open(tmp / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except Exception:  # the rank's boundary: report and fail the world
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    _target, _rank, _world, _threads, _tmp = sys.argv[1:6]
    sys.exit(_rank_main(_target, int(_rank), int(_world), int(_threads), Path(_tmp)))
