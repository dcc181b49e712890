"""Rank bodies of the port's parallel tests, and the collectives' own test.

Each rank of a `parallel.launch.run_ranks` world runs `run_cases` on the
job a test of `test_torch_parallel*.py` wrote: for every case it builds
the mesh, the port's model with the case's parameters, a `Trainer` on the
mesh, takes its block of the stacked batch and runs an eval step and one
SGD train step, or a `fit`; it returns the numbers the test compares with
JAX. `run_scripts` runs the train scripts on a mesh
(`test_torch_scripts.py`), `shard_step_on_cpu` a step from a copy of the
port alone (`test_torch_imports.py`). This module imports neither jax nor
a test module, so the ranks start on torch alone.

`test_collectives_are_exact_transposes` (2 gloo ranks on the CPU) holds
each collective's forward and backward to its definition and its exact
transpose, and the rank helpers of `parallel.distributed` to theirs.
"""

import os
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def _model(case, device="cpu"):
    from matten_tpu_torch.models import create_atomic_tensor_model, create_scalar_tensor_model

    create = create_atomic_tensor_model if case["family"] == "atomic" else create_scalar_tensor_model
    model = create(case["hparams"], case["ds"], device=device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()})
    return model


def _tasks(case):
    from matten_tpu_torch.train import CanonicalRegressionTask

    return [CanonicalRegressionTask(name=name, per_atom=per_atom) for name, per_atom in case["tasks"]]


def _numbers(loss, metrics):
    return float(loss), {k: (float(s), float(c)) for k, (s, c) in metrics.items()}


def _step(case, mesh):
    from matten_tpu_torch.parallel import shard_batch
    from matten_tpu_torch.parallel.collectives import captures_collectives
    from matten_tpu_torch.train import Trainer, TrainerConfig

    tasks = _tasks(case)
    trainer = Trainer(_model(case), tasks, TrainerConfig(lr=0.01, optimizer="sgd", scheduler="none"),
                      device="cpu", mesh=mesh)
    data, targets = shard_batch(mesh, *case["batch"], "cpu", [t.name for t in tasks if t.per_atom])
    out = {"eval": _numbers(*trainer.eval_step(data, targets))}
    out["train"] = _numbers(*trainer.train_step(data, targets))
    out["state"] = {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()}
    # the backend choice of the step graphs: gloo's step groups are not captured
    out["graphs"] = (captures_collectives(mesh), trainer._graphs is not None)
    return out


class _DataModule:
    def __init__(self, loader):
        self.loader = loader

    def train_dataloader(self):
        return self.loader()

    val_dataloader = test_dataloader = train_dataloader


def _fit(case, mesh):
    from matten_tpu_torch.data.datamodule import BatchLoader
    from matten_tpu_torch.train import Trainer, TrainerConfig

    trainer = Trainer(_model(case), _tasks(case), TrainerConfig(**case["config"]), device="cpu",
                      mesh=mesh)
    history = trainer.fit(_DataModule(lambda: BatchLoader(case["graphs"], **case["loader"])))
    return {"history": history,
            "state": {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()}}


def run_cases(rank, world_size, cases):
    """Every case on this rank, in order: {name: result}."""
    from matten_tpu_torch.parallel import make_mesh

    torch.manual_seed(0)
    out = {}
    for case in cases:
        mesh = make_mesh(case["n_data"], case["n_graph"], case["mode"])
        out[case["name"]] = (_fit if case.get("kind") == "fit" else _step)(case, mesh)
    return out


def _tiny_node_trainer(hparams):
    """A tiny model's SGD trainer on a 1 x 2 node mesh of this world, and
    this rank's block of a batch of 4 seeded crystals."""
    from matten_tpu_torch.data.datamodule import BatchLoader
    from matten_tpu_torch.data.graph import CrystalGraph
    from matten_tpu_torch.data.structure import Structure
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.parallel import make_mesh, shard_batch
    from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig

    rng = np.random.default_rng(0)
    graphs = []
    for _ in range(4):
        g = CrystalGraph.from_structure(Structure(
            lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2,
            frac_coords=rng.uniform(0, 1, size=(4, 3)), atomic_numbers=rng.choice([8, 14], size=4)),
            r_cut=5.0)
        g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
        graphs.append(g)
    mesh = make_mesh(1, 2, "node")
    model = create_scalar_tensor_model(
        dict(hparams, graph_parallel_axis="graph", graph_parallel_mode="node"),
        dict(allowed_species=[8, 14], average_num_neighbors=20.0), device="cpu")
    trainer = Trainer(model, [CanonicalRegressionTask(name="elastic_tensor_full")],
                      TrainerConfig(lr=0.01, optimizer="sgd"), device="cpu", mesh=mesh)
    batch = next(iter(BatchLoader(graphs, batch_size=4, species_map=atomic_number_map([8, 14]),
                                  num_edge_shards=2, node_shard=True)))
    return trainer, shard_batch(mesh, *batch, "cpu")


def shard_step_on_cpu(rank, world_size, job):
    """One 2-rank node-mode step of a tiny model from its own seeded crystals
    (the imports test runs it from a copy of the port alone): (the loss,
    the modules of JAX, pandas, pyyaml, sklearn or `matten_tpu` loaded)."""
    import sys

    trainer, batch = _tiny_node_trainer(job["hparams"])
    loss, _ = trainer.train_step(*batch)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "yaml", "sklearn", "matten_tpu"))
    return float(loss), loaded


def run_scripts(rank, world_size, jobs):
    """Each (family, mode, config) job's script `main` on this rank, in
    order: {(family, mode): test metrics}."""
    from matten_tpu_torch.scripts import train_atomic_tensor, train_materials_tensor

    scripts = {"materials": train_materials_tensor, "atomic": train_atomic_tensor}
    return {(kind, mode): scripts[kind].main(config, device="cpu") for kind, mode, config in jobs}


def script_after_slow_setup(rank, world_size, job):
    """The materials script's `main` on this rank of a group rejoined with a
    collective timeout of `job["timeout_s"]`, rank 0's data setup held
    `job["hold_s"]` longer than that: the test metrics."""
    import time

    import torch.distributed as dist

    from matten_tpu_torch.data.datamodule import TensorDataModule
    from matten_tpu_torch.parallel import distributed
    from matten_tpu_torch.scripts import train_materials_tensor

    dist.destroy_process_group()
    distributed.TIMEOUT_S = job["timeout_s"]
    distributed.initialize_distributed(backend="gloo", init_method=f"file://{job['store']}",
                                       world_size=world_size, rank=rank)
    setup = TensorDataModule.setup

    def held(self):
        if rank == 0:
            time.sleep(job["hold_s"])
        return setup(self)

    TensorDataModule.setup = held
    return train_materials_tensor.main(job["config"], device="cpu")


def thread_counts(rank, world_size, _):
    """This rank's torch threads and the BLAS thread counts of its environment."""
    return torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS"), os.environ.get("OPENBLAS_NUM_THREADS")


class _Graph:
    """Stands for a captured step in `graphs._LIVE`."""


_KEPT = []


def eval_forward_before_free(rank, world_size, job):
    """A tiny trainer on a 1 x 2 node mesh with stand-in step graphs that
    hold this rank's block as a capture's static inputs: its graphs
    dropped before any profiler session, during one and after one. Per
    drop: whether each eager eval step ran under the profiler, the model's
    mode after it, and the graphs left."""
    import os
    import tempfile

    import torch

    from matten_tpu_torch.train.graphs import StepGraphs
    from matten_tpu_torch.utils.timing import profile_trace

    os.environ.pop("TEARDOWN_CUPTI", None)  # the port's to set in this process
    trainer, (data, targets) = _tiny_node_trainer(job["hparams"])
    runs, eval_step = [], trainer._eval_step

    def recorded(d, t):
        runs.append((torch.autograd._profiler_enabled(), d is data and t is targets))
        return eval_step(d, t)
    trainer._eval_step = recorded
    graphs = StepGraphs({}, forward=trainer._eval_forward)
    out = []

    def drop(kind):
        for k in ("train", "eval"):
            graphs.graphs[(k,)] = _Graph()
            graphs.graphs[(k,)].data, graphs.graphs[(k,)].targets = data, targets
        trainer.model.train()
        runs.clear()
        graphs.drop(kind)
        out.append({"runs": list(runs), "training": trainer.model.training, "left": sorted(graphs.graphs)})

    with tempfile.TemporaryDirectory() as tmp:
        drop("train")  # before any session
        with profile_trace(tmp):
            drop("train")  # during one
        drop("train")  # after one
        drop(None)
    return out


def refused_after_a_free(rank, world_size, _):
    """A profiler session, then stand-in step graphs freed, then another
    session: refused where the user set TEARDOWN_CUPTI."""
    import tempfile

    import torch.distributed as dist

    from matten_tpu_torch.train.graphs import StepGraphs
    from matten_tpu_torch.utils.timing import profile_trace

    graphs = StepGraphs({})
    graphs.graphs[("train",)] = _Graph()
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp):
            dist.barrier()
        graphs.drop()
        with profile_trace(tmp):
            raise AssertionError("the refused session's block ran")


def graph_left_alive(rank, world_size, _):
    """Rank 1 keeps a (stand-in) step graph alive past its target."""
    from matten_tpu_torch.train import graphs

    if rank == 1:
        _KEPT.append(_Graph())
        graphs._LIVE.add(_KEPT[-1])
    return rank


def both_fail(rank, world_size, _):
    """Rank 1 fails; rank 0 fails after it, in a barrier that rank 1 never
    reaches (gloo raises once rank 1's connection closes)."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 fails first")
    try:
        dist.barrier()
    except RuntimeError as err:
        raise RuntimeError("rank 0 fails after its peer") from err
    return rank


def collectives_on_cpu(rank, world_size, _):
    """Each collective over a 2-rank graph axis on x_r = 10 r + [0 1 2 3]
    (all_gather: those as [2, 2]), pulled back with the cotangent
    c_r = (r + 1) (its row index + 1): {name: (forward, x.grad)}; and the
    rank helpers."""
    from matten_tpu_torch.parallel import collectives as C
    from matten_tpu_torch.parallel.distributed import is_primary_host, make_multihost_mesh, rank_zero_only

    mesh = make_multihost_mesh(n_graph=2)
    axis = mesh.graph
    out = {}
    for name in ("psum", "pmean", "all_gather", "ring_shift", "pmax", "pmin"):
        x = (10.0 * rank + torch.arange(4.0)).reshape(2, 2).requires_grad_()
        # pmax / pmin: one rank holds each extreme entry
        if name in ("pmax", "pmin"):
            x = (torch.tensor([[1.0, 7.0], [5.0, 2.0]]) * (1 if rank == 0 else -1) + 3.0).requires_grad_()
        y = getattr(C, name)(x, axis)
        c = (rank + 1) * (1.0 + torch.arange(y.shape[0], dtype=y.dtype))[:, None].expand_as(y)
        (y * c).sum().backward()
        out[name] = (y.detach().numpy().copy(), x.detach().numpy().copy(), x.grad.numpy().copy())
    out["helpers"] = (mesh.n_data, mesh.n_graph, axis.index, is_primary_host(), rank_zero_only(lambda: rank)())
    return out


def test_collectives_are_exact_transposes():
    from matten_tpu_torch.parallel.launch import run_ranks

    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)]), "OMP_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}
    r = run_ranks("test_torch_parallel_ranks:collectives_on_cpu", 2, None, timeout_s=120, env=env)
    rows = np.array([[1.0], [2.0]])
    for name in ("psum", "pmean", "all_gather", "ring_shift", "pmax", "pmin"):
        (y0, x0, g0), (y1, x1, g1) = r[0][name], r[1][name]
        c0, c1 = rows[: len(y0)] * 1, rows[: len(y0)] * 2
        if name in ("psum", "pmean"):
            n = 2 if name == "pmean" else 1
            want_y, want_g = ((x0 + x1) / n,) * 2, ((c0 + c1) / n,) * 2
        elif name == "all_gather":
            c0 = np.arange(1.0, 5.0)[:, None] * 1
            c1 = c0 * 2
            want_y, want_g = (np.concatenate([x0, x1]),) * 2, ((c0 + c1)[:2], (c0 + c1)[2:])
        elif name == "ring_shift":
            want_y, want_g = (x1, x0), (c1, c0)  # y_{i+1} = x_i: dx_i = dy_{i+1}
        else:
            y = np.maximum(x0, x1) if name == "pmax" else np.minimum(x0, x1)
            want_y, want_g = (y, y), ((c0 + c1) * (x0 == y), (c0 + c1) * (x1 == y))
        for got, want in zip((y0, y1, g0, g1), want_y + want_g):
            np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), err_msg=name)
    assert r[0]["helpers"] == (1, 2, 0, True, 0) and r[1]["helpers"] == (1, 2, 1, False, None)
