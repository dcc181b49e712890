"""The host side of the graphed mesh steps and of `predict`, on the CPU.

A mesh rank's step is captured with its collectives when every group the
step uses is nccl's, so a captured step cannot read back `edge_plan`'s index
check: each rank's numpy block is checked on the host before its copy
(`parallel.sharding.check_block_edges`) with the bounds of the edge plans
its mode builds. Here, on the port loader's stacked layouts (edge, node and
node_ring at 1 x 2 and 2 x 2): every rank's block passes, and four
corruptions per mode raise; on each block the host check agrees with
`edge_plan` (the conv's own check) at the plan's bounds; `Trainer.
_device_group` raises before any of a group is copied. Then the backend
choice (`captures_collectives`: graphs only when every step group is
nccl's), the mesh's shape and mode in a step graph's key, and `predict`'s
chunks: each checked on the host before its copy, and a call over many
chunks equal to one call per chunk.
"""

import copy
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from matten_tpu_torch import predict as predict_mod
from matten_tpu_torch.data import keys as K
from matten_tpu_torch.data.datamodule import BatchLoader
from matten_tpu_torch.data.graph import CrystalGraph
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.kernels import fused_conv
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.parallel.collectives import captures_collectives
from matten_tpu_torch.parallel.sharding import MESH, Axis, Mesh, check_block_edges, local_block
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig
from matten_tpu_torch.train.config import MeshSpec
from matten_tpu_torch.train.graphs import StepGraphs, batch_key, can_capture
from matten_tpu_torch.utils.anomaly import DetectAnomaly

TARGET = "elastic_tensor_full"
SPECIES = (8, 14)
SMAP = atomic_number_map(SPECIES)
MODES = ("edge", "node", "node_ring")
LAYOUTS = ((1, 2), (2, 2))
CORRUPTIONS = ("src out of range", "dst out of range", "dst out of order", "src outside its chunk")
HPARAMS = dict(
    species_embedding_dim=8, irreps_edge_sh="0e+1o+2e", num_radial_basis=8, radial_basis_start=0.0,
    radial_basis_end=5.0, radial_basis_type="bessel", num_layers=1, invariant_layers=1, invariant_neurons=8,
    average_num_neighbors=20.0, conv_layer_irreps="4x0o+4x0e+2x1o+2x1e", nonlinearity_type="gate",
    normalization=None, conv_to_output_hidden_irreps_out="4x0e+2x2e+4e", output_format="irreps",
    output_formula="ijkl=jikl=klij", reduce="mean",
)
DS = {"allowed_species": list(SPECIES), "average_num_neighbors": 20.0}


def _structures(n, seed, atoms=(3, 7)):
    rng = np.random.default_rng(seed)
    return [Structure(lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2,
                      frac_coords=rng.uniform(0, 1, size=(k, 3)), atomic_numbers=rng.choice(SPECIES, size=k))
            for k in rng.integers(atoms[0], atoms[1] + 1, size=n)]


def _graphs(n=8, seed=0):
    rng = np.random.default_rng(seed + 100)
    out = []
    for s in _structures(n, seed):
        g = CrystalGraph.from_structure(s, r_cut=5.0)
        g.y[TARGET] = rng.normal(size=(1, 21))
        out.append(g)
    return out


def _mesh(n_data, n_graph, mode, rank):
    """Rank `rank`'s place in the mesh, without process groups: what the
    layouts and the checks read."""
    s, g = divmod(rank, n_graph)
    return Mesh(n_data, n_graph, rank,
                Axis("data", n_data, s, tuple(range(g, n_data * n_graph, n_graph))),
                Axis("graph", n_graph, g, tuple(range(s * n_graph, (s + 1) * n_graph))), mode)


@functools.lru_cache(maxsize=None)
def _stacked(n_data, n_graph, mode):
    """The port loader's stacked batch of 8 crystals for the mesh."""
    return next(iter(BatchLoader(_graphs(), 8, SMAP, **MeshSpec(n_data, n_graph, mode).loader_kwargs())))


def _plan_groups(mesh, data):
    """(src, dst, n_in, n_out) of each edge plan the conv builds on the
    block (`nn/conv.py`): one, or one per ring group."""
    src, dst = (torch.as_tensor(np.ascontiguousarray(x)) for x in data[K.EDGE_INDEX])
    c, sg = data[K.NODE_MASK].shape[0], mesh.n_graph
    if mesh.mode == "node_ring":
        cap = src.shape[0] // sg
        return [((src[g * cap:(g + 1) * cap] - g * c).contiguous(), dst[g * cap:(g + 1) * cap].contiguous(), c, c)
                for g in range(sg)]
    return [(src, dst, sg * c if mesh.mode == "node" else c, c)]


def _plans_accept(mesh, data):
    try:
        for src, dst, n_in, n_out in _plan_groups(mesh, data):
            fused_conv.edge_plan(src, dst, n_in, n_out)
    except ValueError:
        return False
    return True


def _bad_block(n_data, n_graph, mode, how):
    """(mesh, block) of the last rank whose block has a real edge e with
    dst[e] < dst[e + 1] in one ring group (in the block, outside the ring
    mode), the block a copy with that edge made bad."""
    for rank in reversed(range(n_data * n_graph)):
        mesh = _mesh(n_data, n_graph, mode, rank)
        data = local_block(mesh, _stacked(n_data, n_graph, mode))[0]
        data = dict(data, **{K.EDGE_INDEX: np.array(data[K.EDGE_INDEX])})
        src, dst = data[K.EDGE_INDEX]
        c, real = data[K.NODE_MASK].shape[0], np.asarray(data[K.EDGE_MASK])
        cap = src.shape[0] // n_graph if mode == "node_ring" else src.shape[0]
        e = next((i for i in range(src.shape[0] - 1)
                  if real[i] and dst[i] < dst[i + 1] and (i + 1) // cap == i // cap), None)
        if e is not None:
            break
    g = e // cap
    if how == "src out of range":
        src[e] = n_graph * c if mode in ("node", "node_ring") else c
    elif how == "dst out of range":
        dst[e] = c
    elif how == "dst out of order":
        dst[e], dst[e + 1] = dst[e + 1], dst[e]
    elif mode == "node_ring":
        src[e] = (g + 1) % n_graph * c  # a source of the next chunk: a gathered row, outside its own chunk
    else:
        src[e] = -1
    return mesh, data


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_every_rank_block_passes_the_check_of_its_mode(mode, layout):
    """Each rank's block of the loader's stacked batch passes the host check
    and the conv's edge plans at their bounds; in the node modes its
    sources reach past its own c nodes, so the bound is the mode's."""
    n_data, n_graph = layout
    reach = 0
    for rank in range(n_data * n_graph):
        mesh = _mesh(n_data, n_graph, mode, rank)
        data, _ = local_block(mesh, _stacked(n_data, n_graph, mode))
        check_block_edges(mesh, data)
        assert _plans_accept(mesh, data)
        reach = max(reach, int(np.max(data[K.EDGE_INDEX][0])) - data[K.NODE_MASK].shape[0] + 1)
    assert (reach > 0) == (mode != "edge")


@pytest.mark.parametrize("how", CORRUPTIONS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_a_corrupted_block_raises_as_its_edge_plan_would(mode, layout, how):
    """src out of range, dst out of range, dst out of order, and a source
    outside its ring chunk (outside the ring modes: a negative source), in
    a rank's block: the host check raises edge_plan's ValueError, and the
    conv's edge plans on the same block refuse it too."""
    mesh, data = _bad_block(*layout, mode, how)
    with pytest.raises(ValueError, match="non-decreasing"):
        check_block_edges(mesh, data)
    assert not _plans_accept(mesh, data)


@pytest.mark.parametrize("mode", MODES)
def test_device_group_checks_every_block_before_any_copy(mode, monkeypatch):
    """A mesh trainer's group whose second batch holds a bad block (this
    rank's, at 2 x 2) raises before any of the group is copied; a good
    group is copied, each block with the mesh."""
    mesh, data = _bad_block(2, 2, mode, "dst out of order")
    t = Trainer(torch.nn.Linear(1, 1), [CanonicalRegressionTask(name=TARGET)], TrainerConfig(), device="cpu")
    t.mesh = mesh  # the layouts only: a graph-parallel model is not needed to copy blocks
    good = _stacked(2, 2, mode)
    bad = copy.deepcopy(good)
    local_block(mesh, bad)[0][K.EDGE_INDEX][...] = data[K.EDGE_INDEX]  # a view into `bad`
    copies = []
    monkeypatch.setattr(torch, "from_numpy", lambda a: copies.append(a) or torch.as_tensor(a))
    with pytest.raises(ValueError, match="non-decreasing"):
        t._device_group([good, bad])
    assert copies == []
    ((_, (data, _)),) = t._device_group([good])
    assert data[MESH] is mesh and copies
    np.testing.assert_array_equal(data[K.EDGE_INDEX].numpy(), local_block(mesh, good)[0][K.EDGE_INDEX])


def test_step_graphs_need_every_step_group_on_nccl(monkeypatch):
    """`captures_collectives` reads the backend of the world's group (the
    gradient all-reduce) and of each axis group: graphs only when all are
    nccl's; no mesh, or a mesh of one rank, has no collectives."""
    world, data_g, graph_g = None, "data group", "graph group"
    backends = {}
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backends[group])
    mesh = Mesh(2, 2, 0, Axis("data", 2, 0, (0, 2), data_g), Axis("graph", 2, 0, (0, 1), graph_g), "node_ring")
    for combo, want in (((("nccl",) * 3), True), (("gloo", "nccl", "nccl"), False),
                        (("nccl", "gloo", "nccl"), False), (("nccl", "nccl", "gloo"), False)):
        backends.update(zip((world, data_g, graph_g), combo))
        assert captures_collectives(mesh) is want, combo
    dp = Mesh(4, 1, 0, Axis("data", 4, 0, (0, 1, 2, 3), data_g), Axis("graph", 1, 0, (0,)), "edge")
    backends.update({world: "nccl", data_g: "nccl"})
    assert captures_collectives(dp)
    backends[data_g] = "gloo"
    assert not captures_collectives(dp)
    backends.clear()  # nothing is read
    assert captures_collectives(None) and captures_collectives(_mesh(1, 1, "edge", 0))


def test_a_step_graph_key_holds_the_mesh_shape_and_mode():
    """Two meshes in one process never share a graph: the key holds the
    batch's mesh's (n_data, n_graph, mode) beside the batch key; without a
    mesh, None. On the CPU the first sight of a key runs the step."""
    graphs = StepGraphs({"train": lambda d, t: d["x"] * 2})
    data = {"x": torch.ones(3)}
    keys = [graphs.key("train", dict(data, **{MESH: _mesh(a, b, m, 0)}), {})
            for a, b, m in ((1, 2, "node"), (2, 1, "node"), (1, 2, "node_ring"))]
    assert [k[4] for k in keys] == [(1, 2, "node"), (2, 1, "node"), (1, 2, "node_ring")]
    assert len(set(keys)) == 3 and all(k[-1] == batch_key(data, {}) for k in keys)
    assert graphs.key("train", data, {})[4] is None
    assert torch.equal(graphs.run("train", data, {}), 2 * torch.ones(3)) and not graphs.graphs


def test_mesh_ranks_run_their_eval_forward_under_the_profiler_before_freeing_graphs():
    """`StepGraphs.drop` runs the trainer's eager eval forward on the first
    freed graph's inputs under the profiler before it frees them (the
    repair of CUPTI's fault on later graph launches, `utils.timing.
    _Profile`): during a session inside it, after one in a session of its
    own; on 2 gloo ranks of a node mesh both ranks run it, so its
    collectives meet, and the model keeps its train mode; before any
    session no forward runs. The kinds not dropped stay."""
    import os
    from pathlib import Path

    from matten_tpu_torch.parallel.launch import run_ranks

    root = Path(__file__).resolve().parent
    hp = dict(species_embedding_dim=4, irreps_edge_sh="0e+1o+2e", num_layers=1, invariant_layers=1,
              invariant_neurons=4, average_num_neighbors=20.0, conv_layer_irreps="2x0o+2x0e+1x1o+1x1e",
              normalization="batch", conv_to_output_hidden_irreps_out="2x0e+2e+4e")
    env = {"PYTHONPATH": os.pathsep.join([str(root), str(root.parent)])}
    results = run_ranks("test_torch_parallel_ranks:eval_forward_before_free", 2, {"hparams": hp}, timeout_s=240,
                        env=env)
    for out in results:
        before, during, after, every = out
        assert before == {"runs": [], "training": True, "left": [("eval",)]}
        assert during == {"runs": [(True, True)], "training": True, "left": [("eval",)]}
        assert after == {"runs": [(True, True)], "training": True, "left": [("eval",)]}
        assert every == {"runs": [(True, True)], "training": True, "left": []}


def test_mesh_ranks_are_refused_at_the_same_session_after_a_free_under_the_user_s_setting():
    """With TEARDOWN_CUPTI=0 set by the user for both ranks of a gloo
    world, step graphs freed after a session make each rank's next
    session raise as it starts: the launcher names both ranks, and each
    log ends in the refusal."""
    import os
    from pathlib import Path

    from matten_tpu_torch.parallel.launch import run_ranks

    root = Path(__file__).resolve().parent
    env = {"PYTHONPATH": os.pathsep.join([str(root), str(root.parent)]), "TEARDOWN_CUPTI": "0"}
    with pytest.raises(RuntimeError) as err:
        run_ranks("test_torch_parallel_ranks:refused_after_a_free", 2, timeout_s=120, env=env)
    first = str(err.value).splitlines()[0]
    assert "rank 0 exited with 1" in first and "rank 1 exited with 1" in first, first
    assert str(err.value).count("RuntimeError: profiler session refused") == 2
    assert "the refused session's block ran" not in str(err.value)


class _EagerGraphs(StepGraphs):
    """Step graphs on the CPU: every step runs eagerly, and each key holds a
    stand-in graph with the inputs of its last step."""

    def run(self, kind, data, targets):
        self.graphs[self.key(kind, data, targets)] = type("Held", (), {"data": data, "targets": targets})()
        return self.steps[kind](data, targets)


def test_a_fit_whose_plateau_step_lowers_the_lr_in_a_session_runs_the_forward_before_the_free(monkeypatch,
                                                                                             tmp_path):
    """A `Trainer.fit` profiled whole in one `profile_trace` session, its
    plateau scheduler lowering the lr at each epoch's end (no val score
    improves on a best of -inf), with `_EagerGraphs` for step graphs: each
    `set_lr` frees the train graphs inside the session, after the
    trainer's eval forward ran there, under the profiler, on the freed
    train graph's inputs while it was still held; the eval graph stays."""
    from matten_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "_cupti", dict(timing._cupti, wrote=None, kept=False, dropped=False,
                                               started=False, refuse=None))
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    monkeypatch.delenv("DISABLE_CUPTI_LAZY_REINIT", raising=False)
    graphs = _graphs(4, seed=3)
    data = type("Data", (), {"train_dataloader": lambda self: BatchLoader(graphs, 4, SMAP)})()
    data.val_dataloader = data.train_dataloader
    t = Trainer(create_scalar_tensor_model(HPARAMS, DS, device="cpu"), [CanonicalRegressionTask(name=TARGET)],
                TrainerConfig(max_epochs=2, lr=0.01, lr_patience=0), device="cpu")
    t.scheduler.best = -np.inf
    forwards = []

    def forward(d, tg):
        held = {k[0]: g for k, g in t._graphs.graphs.items()}
        forwards.append((torch.autograd._profiler_enabled(), sorted(held), d is held["train"].data))
        t._eval_forward(d, tg)

    t._graphs = _EagerGraphs({"train": t._flat(t._train_step), "eval": t._flat(t._eval_step)},
                             lambda kind: t.model.train(kind == "train"), forward)
    with timing.profile_trace(str(tmp_path)):
        history = t.fit(data)
    assert [h["epoch"] for h in history] == [0, 1]
    assert [g["lr"] for g in t.optimizer.param_groups] == [0.0025]
    assert forwards == [(True, ["eval", "train"], True)] * 2
    assert [k[0] for k in t._graphs.graphs] == ["eval"]


def test_drop_forgets_one_kind_or_every_graph():
    """`drop(kind)` forgets that kind's graphs (an lr change drops the
    train graphs), `drop()` every graph (what `Trainer.free_graphs` does
    before a mesh's process group goes); the keys seen stay seen, so the
    next step of each captures anew. A CPU trainer has none to free."""
    graphs = StepGraphs({})
    keys = [("train", 1), ("eval", 1), ("train", 2)]
    graphs.graphs, graphs.seen = dict.fromkeys(keys, "graph"), set(keys)
    graphs.drop("train")
    assert list(graphs.graphs) == [("eval", 1)]
    graphs.drop()
    assert graphs.graphs == {} and graphs.seen == set(keys)
    t = Trainer(torch.nn.Linear(1, 1), [CanonicalRegressionTask(name=TARGET)], TrainerConfig(), device="cpu")
    assert t._graphs is None
    t.free_graphs()


def test_only_a_card_model_without_debug_layers_is_captured():
    """Graphs on the card only, and not for a model with DEBUG anomaly
    layers, whose checks read every layer back on the host."""
    model = create_scalar_tensor_model(HPARAMS, DS, device="cpu")
    assert can_capture(model, torch.device("cuda")) and not can_capture(model, torch.device("cpu"))
    assert not can_capture(torch.nn.Sequential(torch.nn.Linear(1, 1), DetectAnomaly("layer")), torch.device("cuda"))


@pytest.fixture(scope="module")
def served():
    """A small model and 18 crystals whose chunks of 3 come in repeated pad
    shapes."""
    model = create_scalar_tensor_model(HPARAMS, DS, device="cpu", seed=5).eval()
    a, b = _structures(3, seed=11, atoms=(2, 3)), _structures(3, seed=12, atoms=(9, 10))
    return model, a + a + b + a + b + _structures(3, seed=13, atoms=(5, 6))


def test_predict_over_chunks_equals_a_call_per_chunk(served):
    """One `predict` call over 6 chunks of 3 pad shapes gives what a call
    per chunk gives, bitwise."""
    model, structures = served
    pads = [predict_mod.pad_spec_for([CrystalGraph.from_structure(s, r_cut=5.0) for s in structures[i:i + 3]])
            for i in range(0, 18, 3)]
    assert len(set(pads)) == 3 and pads[0] == pads[1] == pads[3] and pads[2] == pads[4]
    whole = predict_mod.predict(structures, model, batch_size=3)
    parts = [r for i in range(0, 18, 3) for r in predict_mod.predict(structures[i:i + 3], model, batch_size=3)]
    assert len(whole) == len(parts) == 18
    for x, y in zip(whole, parts):
        assert x.shape == (3, 3, 3, 3) and np.array_equal(np.asarray(x), np.asarray(y))


def test_predict_checks_each_chunk_on_the_host_before_its_copy(served, monkeypatch):
    """A chunk whose collated edges are bad raises edge_plan's ValueError
    before it is copied or served."""
    model, structures = served
    collate = predict_mod.collate_graphs

    def bad_collate(*args, **kwargs):
        data, targets = collate(*args, **kwargs)
        ei = data[K.EDGE_INDEX].copy()
        ei[1] = ei[1][::-1]
        return dict(data, **{K.EDGE_INDEX: ei}), targets

    copied = []
    monkeypatch.setattr(predict_mod, "collate_graphs", bad_collate)
    monkeypatch.setattr(predict_mod, "batch_to_device", lambda *a, **k: copied.append(1))
    with pytest.raises(ValueError, match="non-decreasing"):
        predict_mod.predict(structures[:3], model, batch_size=3)
    assert copied == []
