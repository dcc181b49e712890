"""Start-up of the port's process groups on the CPU.

- `initialize_distributed` under torchrun's environment binds the rank to
  `cuda:LOCAL_RANK` (never `cuda:RANK`): the current device is set and the
  group gets it as `device_id`, under nccl; gloo on the CPU binds nothing.
- `parallel.launch` refuses an nccl world without CUDA, and one larger than
  the visible cards, each with its message, and never falls back to gloo.
- The launcher gives each rank as many BLAS threads as torch threads, and
  fails a rank that leaves a step graph alive before its group goes. A
  failed world's report names every rank that failed, each with its code.
- A host-side wait on the primary rank's work outlives the collectives'
  timeout: the materials script on a 2-rank mesh whose group times out
  after 2 s completes while rank 0's data setup takes 4 s longer.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from matten_tpu_torch.parallel import distributed, launch
from test_torch_scripts import _config, _write_tiny_dataset

ROOT = Path(__file__).resolve().parent.parent
TORCHRUN_ENV = {"RANK": "5", "LOCAL_RANK": "1", "WORLD_SIZE": "8", "MASTER_ADDR": "localhost",
                "MASTER_PORT": "29500"}


@pytest.mark.parametrize("kwargs,backend,card", [
    (dict(backend="nccl"), "nccl", torch.device("cuda", 1)),
    (dict(device="cuda"), "nccl", torch.device("cuda", 1)),
    (dict(device="cuda:3"), "nccl", torch.device("cuda", 3)),
    (dict(), "gloo", None),
], ids=["nccl", "cuda", "cuda:3", "cpu"])
def test_torchrun_rank_binds_its_local_card(monkeypatch, kwargs, backend, card):
    for k, v in TORCHRUN_ENV.items():
        monkeypatch.setenv(k, v)
    joined, current = [], []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: joined.append((a, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    assert distributed.initialize_distributed(**kwargs)
    ((args, kw),) = joined
    assert args == (backend,)
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("env://", 8, 5)
    assert kw["timeout"].total_seconds() == distributed.TIMEOUT_S
    if card is None:
        assert "device_id" not in kw and current == []
    else:
        assert kw["device_id"] == card and current == [card]


def test_nccl_refuses_a_cpu_device(monkeypatch):
    for k, v in TORCHRUN_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(ValueError, match="nccl backend runs on CUDA devices"):
        distributed.initialize_distributed(backend="nccl", device="cpu")


def test_launcher_refuses_nccl_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl backend needs CUDA"):
        launch.start_ranks("test_torch_parallel_ranks:collectives_on_cpu", 2, backend="nccl")


def test_launcher_refuses_a_world_larger_than_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="a world of 4 nccl ranks needs 4 cards, one per rank; 2 visible"):
        launch.start_ranks("test_torch_parallel_ranks:collectives_on_cpu", 4, backend="nccl")


def test_launcher_gives_each_rank_its_blas_threads(monkeypatch):
    """Ranks that each start a BLAS thread per core spin on one another's
    cores: four such ranks took minutes for a first forward of the
    production model that takes seconds at two threads each."""
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    monkeypatch.delenv("OPENBLAS_NUM_THREADS", raising=False)
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)])}
    ranks = launch.run_ranks("test_torch_parallel_ranks:thread_counts", 2, threads=2, timeout_s=120, env=env)
    assert ranks == [(2, "2", "2")] * 2


def test_launcher_fails_a_rank_that_leaves_a_step_graph_alive():
    """NCCL destroys a communicator only once every graph that captured its
    operations is gone: a rank whose target leaves a step graph alive fails
    with its count instead of destroying the group under it."""
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)])}
    with pytest.raises(RuntimeError, match=r"rank 1 exited with 1(.|\n)*left 1 step graph\(s\) alive"):
        launch.run_ranks("test_torch_parallel_ranks:graph_left_alive", 2, timeout_s=120, env=env)


def test_launcher_names_every_rank_that_failed():
    """A peer's later failure never hides the rank that failed first: rank
    1 fails, rank 0 fails after it (its barrier's peer is gone), and the
    report names both with their codes, and keeps both logs."""
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)])}
    with pytest.raises(RuntimeError) as err:
        launch.run_ranks("test_torch_parallel_ranks:both_fail", 2, timeout_s=120, env=env)
    first = str(err.value).splitlines()[0]
    assert "rank 1 exited with 1" in first and "rank 0 exited with 1" in first, first
    assert "rank 1 fails first" in str(err.value) and "rank 0 fails after its peer" in str(err.value)


def test_setup_wait_outlives_the_group_timeout(tmp_path):
    """Rank 1 waits for rank 0's data setup on the mesh's host group; with
    the default group's 2 s timeout bounding that wait (a barrier on the
    default group), rank 1 failed after 2 s."""
    _write_tiny_dataset(tmp_path / "tiny.json", "materials")
    config = _config(tmp_path, "materials", "ckpt")
    config["trainer"].update(max_epochs=1, mesh={"data": 1, "graph": 2, "mode": "node"})
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)]), "OMP_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}
    job = {"config": config, "store": str(tmp_path / "store"), "timeout_s": 2.0, "hold_s": 4.0}
    r0, r1 = launch.run_ranks("test_torch_parallel_ranks:script_after_slow_setup", 2, job, timeout_s=240, env=env)
    assert r0 == r1 and all(np.isfinite(list(r0.values())))
    assert (tmp_path / "ckpt" / "last").is_dir()
