"""The port's data and graph parallel train step against the JAX package's.

Mirrors `tests/parallel/test_dp.py` (without its scan and chunked-kernel
tests: `scan_steps` is held to the JAX loop in `test_torch_scan_steps.py`,
and the port has no chunk-aligned layout).
The JAX file's small model and 8 crystals; parameters from the JAX
`init_state(rng_seed=0)`, carried over with `convert.flax_to_state_dict`.
The port's ranks are processes of one 4-rank gloo world on the CPU
(`parallel.launch`, rank bodies in `test_torch_parallel_ranks.py`),
started once for the module, while this process runs the JAX steps; each
rank takes its block of the port loader's stacked batch and runs one SGD
step (lr 0.01), or a 2-epoch `fit`. Each case is held to the JAX
single-device step on the whole batch and to the JAX sharded step on a
mesh of the same shape (8 virtual CPU devices, tests/conftest.py):

  * data parallel 4 x 1, with a ragged tail (3 crystals over 4 shards);
  * edge 2 x 2; node 2 x 2 without batch norm, and with it at 1 x 4 (the
    statistics of the whole graph, so the single-device step) and at
    2 x 2 (per data shard, as in data parallelism: the JAX sharded step
    only); the per-atom NMR model at node 2 x 2; node_ring 2 x 2;
  * instance norm under node 2 x 2: a graph cut by a node shard is
    normalized over its local nodes, in both packages (ROADMAP §3), so it
    is held to the JAX sharded step only;
  * a data-parallel `fit` with batch norm against the JAX `fit` on the
    same 4 x 1 mesh.

Tolerances, the JAX file's: loss and metric sums 1e-5 relative,
parameters after the step 2e-5 absolute (batch-norm running statistics
1e-5); every rank holds the same parameters, bitwise.
"""

import dataclasses
import os
from pathlib import Path

import jax
import numpy as np
import pytest

from matten_tpu.data.datamodule import BatchLoader as JaxLoader
from matten_tpu.data.graph import CrystalGraph as JaxGraph
from matten_tpu.data.structure import Structure
from matten_tpu.models import create_atomic_tensor_model as jax_atomic_model
from matten_tpu.models import create_scalar_tensor_model as jax_scalar_model
from matten_tpu.nn.embedding import atomic_number_map
from matten_tpu.parallel.sharding import make_mesh as jax_make_mesh
from matten_tpu.train import CanonicalRegressionTask as JaxTask
from matten_tpu.train import Trainer as JaxTrainer
from matten_tpu.train import TrainerConfig as JaxConfig
from matten_tpu_torch.convert import flax_to_state_dict
from matten_tpu_torch.data.datamodule import BatchLoader
from matten_tpu_torch.data.graph import CrystalGraph
from matten_tpu_torch.models import create_atomic_tensor_model, create_scalar_tensor_model
from matten_tpu_torch.parallel import make_mesh
from matten_tpu_torch.parallel.launch import start_ranks
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig
from matten_tpu_torch.train.config import MeshSpec

ROOT = Path(__file__).resolve().parent.parent
# the ranks import the rank bodies from tests/ and the port from the repo,
# and run one BLAS thread, as the suite runs in several workers
RANK_ENV = {"PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)]), "OMP_NUM_THREADS": "1",
            "OPENBLAS_NUM_THREADS": "1"}
RANK_TIMEOUT_S = 240

HPARAMS = dict(
    species_embedding_dim=8,
    irreps_edge_sh="0e+1o+2e",
    num_radial_basis=8,
    radial_basis_start=0.0,
    radial_basis_end=5.0,
    radial_basis_type="bessel",
    num_layers=1,
    invariant_layers=1,
    invariant_neurons=8,
    average_num_neighbors=20.0,
    conv_layer_irreps="4x0o+4x0e+2x1o+2x1e",
    nonlinearity_type="gate",
    normalization=None,
    conv_to_output_hidden_irreps_out="4x0e+2x2e+4e",
    output_format="irreps",
    output_formula="ijkl=jikl=klij",
    reduce="mean",
)
DS = {"allowed_species": [8, 14], "average_num_neighbors": 20.0, "atom_feats_size": None}
SMAP = atomic_number_map((8, 14))
ELASTIC, NMR = "elastic_tensor_full", "nmr_tensor"
LOADER = dict(node_multiple=32, edge_multiple=512, node_chunk=None)
SGD = dict(max_epochs=1, lr=0.01, optimizer="sgd")


def jax_graphs(rng, n):
    """The JAX test's crystals: 4 atoms of O or Si, a 21-value target."""
    out = []
    for _ in range(n):
        s = Structure(
            lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2,
            frac_coords=rng.uniform(0, 1, size=(4, 3)),
            atomic_numbers=rng.choice([8, 14], size=4),
        )
        g = JaxGraph.from_structure(s, r_cut=5.0)
        g.y[ELASTIC] = rng.normal(size=(1, 21))
        out.append(g)
    return out


def nmr_graphs():
    """The JAX test's per-atom crystals: a random selector and 6 values
    per selected atom."""
    rng = np.random.default_rng(7)
    graphs = jax_graphs(rng, 8)
    for g in graphs:
        del g.y[ELASTIC]
        sel = rng.integers(0, 2, g.num_nodes).astype(bool)
        sel[0] = True
        dense = np.zeros((g.num_nodes, 6))
        dense[sel] = rng.normal(size=(int(sel.sum()), 6))
        g.y[NMR] = dense
        g.y["atom_selector"] = sel
    return graphs


def port_graphs(graphs):
    return [CrystalGraph(**{f.name: getattr(g, f.name) for f in dataclasses.fields(JaxGraph)})
            for g in graphs]


def shard_kwargs(n_data, n_graph, mode):
    return MeshSpec(n_data, n_graph, mode).loader_kwargs()


def parallel_hparams(hp, n_graph, mode):
    return dict(hp, graph_parallel_axis="graph", graph_parallel_mode=mode) if n_graph > 1 else hp


def as_state_dict(state, port_model):
    return {k: v.numpy() for k, v in flax_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}, port_model).items()}


def fresh(state):
    """A copy of a JAX train state (the jitted steps donate theirs)."""
    return jax.tree.map(lambda x: np.array(x), state)


class Case:
    """One sharded step (or fit): its port job, and its JAX steps."""

    def __init__(self, name, n_data, n_graph, mode, hp=HPARAMS, graphs=None, batch_size=8,
                 per_atom=False, single=True, fit=False, eval_only_sharded=False):
        self.name, self.n_data, self.n_graph, self.mode = name, n_data, n_graph, mode
        self.hp, self.per_atom, self.single, self.fit = hp, per_atom, single, fit
        self.eval_only_sharded = eval_only_sharded
        self.graphs = graphs if graphs is not None else jax_graphs(np.random.default_rng(0), 8)
        self.batch_size = batch_size
        self.target = NMR if per_atom else ELASTIC
        create = jax_atomic_model if per_atom else jax_scalar_model
        self.jax_single = create(hp, DS)
        self.jax_sharded = create(parallel_hparams(hp, n_graph, mode), DS)
        port_create = create_atomic_tensor_model if per_atom else create_scalar_tensor_model
        self.port_model = port_create(parallel_hparams(hp, n_graph, mode), DS, device="cpu")
        self.single_batch = next(iter(JaxLoader(self.graphs, len(self.graphs), SMAP, **LOADER)))
        self.trainer_single = JaxTrainer(self.jax_single, self.tasks(), JaxConfig(**SGD))
        self.state = self.trainer_single.init_state(self.single_batch, rng_seed=0)

    def tasks(self):
        return [JaxTask(name=self.target, per_atom=self.per_atom)]

    def loader_args(self, shuffle=False):
        return dict(batch_size=self.batch_size, species_map=SMAP, shuffle=shuffle,
                    **shard_kwargs(self.n_data, self.n_graph, self.mode), **LOADER)

    def job(self):
        job = dict(name=self.name, n_data=self.n_data, n_graph=self.n_graph, mode=self.mode,
                   family="atomic" if self.per_atom else "scalar",
                   hparams=parallel_hparams(self.hp, self.n_graph, self.mode), ds=DS,
                   state=as_state_dict(self.state, self.port_model), tasks=[(self.target, self.per_atom)])
        graphs = port_graphs(self.graphs)
        if self.fit:
            job.update(kind="fit", graphs=graphs, loader=self.loader_args(shuffle=True),
                       config=dict(SGD, max_epochs=2))
        else:
            job["batch"] = next(iter(BatchLoader(graphs, **self.loader_args())))
        return job

    def jax_mesh_trainer(self, **config):
        mesh = jax_make_mesh(n_data=self.n_data, n_graph=self.n_graph)
        return mesh, JaxTrainer(self.jax_sharded, self.tasks(), JaxConfig(**dict(SGD, **config)), mesh=mesh,
                                graph_shard_mode=self.mode)

    def jax_results(self):
        """{"single": ..., "sharded": ...}: (loss, metric sum, state dict)
        of each JAX step, or the fit's (history, state dict)."""
        if self.fit:
            _, trainer = self.jax_mesh_trainer(max_epochs=2)
            loader = JaxLoader(self.graphs, **self.loader_args(shuffle=True))

            class DM:
                def train_dataloader(self):
                    return loader

                val_dataloader = test_dataloader = train_dataloader

            state = trainer.fit(fresh(self.state), DM())
            return {"sharded": (trainer.history, as_state_dict(state, self.port_model))}
        out = {}
        if self.single:
            d, t = self.trainer_single._to_device(self.single_batch)
            out["single"] = self._numbers(*self.trainer_single._train_step(fresh(self.state), d, t))
        mesh, trainer = self.jax_mesh_trainer()
        data, targets = next(iter(JaxLoader(self.graphs, **self.loader_args())))
        if self.n_graph == 1:
            d, t = trainer._to_device((data, targets))
        else:
            d, t = ({k: jax.numpy.asarray(v) for k, v in x.items()} for x in (data, targets))
        if self.eval_only_sharded:
            loss, ms = trainer._eval_step(fresh(self.state), d, t)
            out["sharded_eval"] = (float(loss), float(ms[self.target][0]))
        else:
            out["sharded"] = self._numbers(*trainer._train_step(fresh(self.state), d, t))
        return out

    def _numbers(self, state, loss, metrics):
        return float(loss), float(metrics[self.target][0]), as_state_dict(state, self.port_model)


def run_world(cases, world_size):
    """The port's ranks on every case, while the JAX steps run here:
    {name: (port results per rank, JAX results)}."""
    jobs = [c.job() for c in cases]
    with start_ranks("test_torch_parallel_ranks:run_cases", world_size, jobs, timeout_s=RANK_TIMEOUT_S,
                     env=RANK_ENV) as ranks:
        ref = {c.name: c.jax_results() for c in cases}
        port = ranks.join()
    return {c.name: ([r[c.name] for r in port], ref[c.name]) for c in cases}


def assert_step_matches(port, ref, name):
    """Every rank's step against each JAX step the case has."""
    for r in port[1:]:
        for k, v in port[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=f"{name}: ranks differ at {k}")
    loss, (metric, _) = port[0]["train"][0], next(iter(port[0]["train"][1].values()))
    assert set(ref) & {"single", "sharded"}
    for kind in ("single", "sharded"):
        if kind not in ref:
            continue
        ref_loss, ref_metric, ref_state = ref[kind]
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5, err_msg=f"{name} loss vs JAX {kind}")
        np.testing.assert_allclose(metric, ref_metric, rtol=1e-5, err_msg=f"{name} metric vs JAX {kind}")
        assert set(port[0]["state"]) == set(ref_state)
        for k, v in ref_state.items():
            atol = 1e-5 if "running" in k else 2e-5
            np.testing.assert_allclose(port[0]["state"][k], v, atol=atol, err_msg=f"{name} {k} vs JAX {kind}")


def _cases():
    g8 = jax_graphs(np.random.default_rng(0), 8)
    bn = dict(HPARAMS, normalization="batch")
    nmr = {k: v for k, v in HPARAMS.items() if k != "conv_to_output_hidden_irreps_out"}
    return [
        Case("dp 4x1", 4, 1, "edge", graphs=g8),
        # 3 crystals strided over 4 shards: shard 3 is all-masked
        Case("dp ragged 4x1", 4, 1, "edge", graphs=g8[:3], batch_size=8),
        Case("edge 2x2", 2, 2, "edge", graphs=g8),
        Case("node 2x2", 2, 2, "node", graphs=g8),
        Case("node batch norm 1x4", 1, 4, "node", hp=bn, graphs=g8),
        # batch-norm statistics per data shard, as in data parallelism
        Case("node batch norm 2x2", 2, 2, "node", hp=bn, graphs=g8, single=False),
        Case("per-atom node 2x2", 2, 2, "node", hp=dict(nmr, output_formula="ij=ji"), graphs=nmr_graphs(),
             per_atom=True),
        Case("node_ring 2x2", 2, 2, "node_ring", graphs=g8),
        Case("instance norm node 2x2", 2, 2, "node", hp=dict(HPARAMS, normalization="instance"), graphs=g8,
             single=False),
        Case("dp fit batch norm 4x1", 4, 1, "edge", hp=bn, graphs=g8, fit=True),
    ]


CASE_NAMES = [
    "dp 4x1", "dp ragged 4x1", "edge 2x2", "node 2x2", "node batch norm 1x4", "node batch norm 2x2",
    "per-atom node 2x2", "node_ring 2x2", "instance norm node 2x2",
]


@pytest.fixture(scope="module")
def world():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"
    return run_world(_cases(), 4)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_sharded_step_matches_jax(world, name):
    port, ref = world[name]
    assert_step_matches(port, ref, name)


def test_ragged_tail_shard_is_all_masked():
    graphs = port_graphs(jax_graphs(np.random.default_rng(0), 3))
    data, _ = next(iter(BatchLoader(graphs, 8, SMAP, **shard_kwargs(4, 1, "edge"), **LOADER)))
    assert data["pos"].shape[0] == 4
    assert not data["graph_mask"][3].any() and not data["node_mask"][3].any()
    assert int(data["graph_mask"].sum()) == 3


def test_dp_fit_with_batch_norm_matches_jax(world):
    port, ref = world["dp fit batch norm 4x1"]
    history, state = ref["sharded"]
    for r in port:
        assert len(r["history"]) == 2 and np.isfinite(r["history"][-1]["val/score"])
        for k, v in port[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v)
    for ours, want in zip(port[0]["history"], history):
        for key in ("train/loss", "val/loss", "val/score", f"val/mae/{ELASTIC}"):
            np.testing.assert_allclose(ours[key], want[key], rtol=1e-5, err_msg=key)
    for k, v in state.items():
        np.testing.assert_allclose(port[0]["state"][k], v, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["edge", "node", "node_ring"])
def test_converted_parameters_of_a_graph_parallel_jax_model_load_strictly(mode):
    """Graph parallelism leaves the parameter tree as it is: the flax
    variables of a JAX model built with `graph_parallel_axis="graph"`
    load into the port's graph-parallel model, strictly."""
    hp = parallel_hparams(dict(HPARAMS, normalization="batch"), 2, mode)
    graphs = jax_graphs(np.random.default_rng(0), 4)
    data, _ = next(iter(JaxLoader(graphs, 4, SMAP, **LOADER)))
    variables = jax_scalar_model(hp, DS).init(jax.random.PRNGKey(1), data)
    port = create_scalar_tensor_model(hp, DS, device="cpu")
    port.load_state_dict(flax_to_state_dict(variables, port), strict=True)


def test_trainer_takes_the_graph_mode_from_the_mesh():
    """The mesh names the graph shard mode; a trainer refuses a mesh whose
    mode is not the one the model's convs were built for, and `make_mesh`
    an unknown mode."""
    task = [CanonicalRegressionTask(name=ELASTIC)]
    model = create_scalar_tensor_model(parallel_hparams(HPARAMS, 2, "node"), DS, device="cpu")
    assert Trainer(model, task, TrainerConfig(), device="cpu", mesh=make_mesh(1, 1, "node")).mesh.mode == "node"
    with pytest.raises(ValueError, match=r"mode 'edge'.*\['node'\]"):
        Trainer(model, task, TrainerConfig(), device="cpu", mesh=make_mesh(1, 1, "edge"))
    with pytest.raises(ValueError, match="graph shard mode 'ring'"):
        make_mesh(1, 1, "ring")
