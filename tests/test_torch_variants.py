"""The model and data options of the port against the JAX package on the CPU.

Modules (rtol=atol=1e-5): segment max / min pooling with exact ties and an
all-padding graph (values and gradients), the instance norm, the norm
activation, the gaussian radial basis and `SpeciesEmbedding` with atom and
global features. Whole models (rtol=atol=1e-4, float32 with another
summation order through a conv layer): each override of
`tests/models/test_variants.py` and the features, multi-task, min / max
pooling and gaussian cases, with parameters converted from the flax tree by
`flax_to_state_dict`, which must cover every leaf. One train-mode step's
parameter gradients (atol 1e-4 after scaling each parameter by its max
|ref|, the rule of `test_torch_train.py`) for the instance norm, the norm
activation, max pooling and all options together (two tasks, target
weights), against `jax.value_and_grad` of the JAX trainer's loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matten_tpu.data import keys as JK
from matten_tpu.data.graph import CrystalGraph, PadSpec, collate_graphs
from matten_tpu.data.structure import Structure
from matten_tpu.models import create_scalar_tensor_model as jax_create_model
from matten_tpu.nn.common import freeze_irreps
from matten_tpu.nn.embedding import EdgeLengthEmbedding as JaxEdgeLengthEmbedding
from matten_tpu.nn.embedding import SpeciesEmbedding as JaxSpeciesEmbedding
from matten_tpu.nn.gate import NormActivation as JaxNormActivation
from matten_tpu.nn.nodewise import NodewiseReduce as JaxNodewiseReduce
from matten_tpu.nn.norm import IrrepsInstanceNorm as JaxInstanceNorm
from matten_tpu.ops.irreps import Irreps as JaxIrreps
from matten_tpu.train import CanonicalRegressionTask as JaxTask
from matten_tpu.train import Trainer as JaxTrainer
from matten_tpu.train import TrainerConfig as JaxConfig
from matten_tpu_torch.convert import flax_to_state_dict
from matten_tpu_torch.data import keys as K
from matten_tpu_torch.data.graph import PadSpec as PortPadSpec
from matten_tpu_torch.data.graph import CrystalGraph as PortCrystalGraph
from matten_tpu_torch.data.graph import collate_graphs as port_collate
from matten_tpu_torch.data.structure import Structure as PortStructure
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.nn.embedding import EdgeLengthEmbedding, SpeciesEmbedding, atomic_number_map
from matten_tpu_torch.nn.gate import ActivationInfo, NormActivation
from matten_tpu_torch.nn.nodewise import NodewiseReduce
from matten_tpu_torch.nn.norm import IrrepsInstanceNorm
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.predict import batch_to_device
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig

torch.set_num_threads(2)

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SPECIES = (8, 14)
TARGET = "elastic_tensor_full"
# tests/models/test_variants.py's BASE
BASE = dict(
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
    conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+2x2e",
    nonlinearity_type="gate",
    normalization="batch",
    conv_to_output_hidden_irreps_out="4x0e+2x2e+4e",
    output_format="irreps",
    output_formula="ijkl=jikl=klij",
    reduce="mean",
)
ATOM_F, GLOBAL_F = 2, 3
DS = dict(allowed_species=list(SPECIES), average_num_neighbors=20.0, atom_feats_size=ATOM_F,
          global_feats_size=GLOBAL_F)
FEATS = dict(use_atom_feats=True, use_global_feats=True)
MULTI = dict(tensor_target_name=TARGET, scalar_target_names=["k_voigt"])
# everything the port refused before, together (the chip's variants configuration, small)
ALL = dict(normalization="instance", nonlinearity_type="norm", radial_basis_type="gaussian",
           reduce="max", **FEATS, **MULTI)
CASES = {
    # the overrides of tests/models/test_variants.py
    "scalar": dict(output_formula="scalar", conv_to_output_hidden_irreps_out="8x0e"),
    "norm_activation": dict(nonlinearity_type="norm"),
    "instance_norm": dict(normalization="instance"),
    "no_norm": dict(normalization=None),
    "ij": dict(output_formula="ij=ji"),
    # and the options beyond them
    "features": FEATS,
    "multi_task": MULTI,
    "min_pool": dict(reduce="min"),
    "max_pool": dict(reduce="max"),
    "gaussian": dict(radial_basis_type="gaussian"),
    "all": ALL,
}


def _fill(tree, seed):
    """Seeded values in a flax layout: N(0, 0.5), positive running_var."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        if "running_var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return (0.5 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, tree)


def _graphs(seed=0, n=3):
    """n small crystals with atom and global features, `k_voigt` and a
    target weight; padded to two more graphs than real ones, so the batch
    holds all-padding graphs."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        k = int(rng.integers(3, 6))
        s = Structure(lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2,
                      frac_coords=rng.uniform(0, 1, (k, 3)), atomic_numbers=rng.choice(SPECIES, k))
        x = {"atom_feats": rng.normal(size=(k, ATOM_F)), "global_feats": rng.normal(size=(1, GLOBAL_F)),
             "target_weight": np.asarray([[rng.uniform(0.5, 2.0)]])}
        y = {TARGET: rng.normal(size=(1, 21)), "k_voigt": rng.normal(size=(1, 1))}
        graphs.append(CrystalGraph.from_structure(s, r_cut=5.0, x=x, y=y))
    nodes = sum(g.num_nodes for g in graphs)
    edges = sum(g.edge_index.shape[1] for g in graphs)
    pad = PadSpec(nodes + 5, edges + 64, n + 2)
    return collate_graphs(graphs, pad, species_map=atomic_number_map(SPECIES))


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_extremum_pooling_matches_jax_with_ties(reduce):
    """Values and gradients of min / max pooling: graph 0 holds exact ties
    (the gradient is spread evenly over them in both), graph 2 holds only
    padded nodes (the result is 0), graph 3 has no node at all."""
    rng = np.random.default_rng(1)
    n, d, g = 10, 5, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[0] = 4.0 if reduce == "max" else -4.0  # graph 0's extremum, tied exactly
    x[1] = x[0]
    x[2, :2] = x[0, :2]
    batch = np.asarray([0, 0, 0, 1, 1, 1, 2, 2, 0, 1], np.int32)
    mask = np.asarray([1, 1, 1, 1, 1, 1, 0, 0, 1, 0], bool)
    cot = rng.normal(size=(g, d)).astype(np.float32)
    irreps = {"f": JaxIrreps(f"{d}x0e")}
    data = {"f": x, K.BATCH: batch, K.NODE_MASK: mask, K.CELL: np.zeros((g, 3, 3), np.float32)}

    jm = JaxNodewiseReduce(irreps_in=freeze_irreps(irreps), field="f", out_field="o", reduce=reduce)

    def jax_loss(xv):
        out = jm.apply({}, dict({k: jnp.asarray(v) for k, v in data.items()}, f=xv))["o"]
        return (out * cot).sum(), out

    (_, ref), ref_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(x))

    tm = NodewiseReduce({"f": Irreps(f"{d}x0e")}, field="f", out_field="o", reduce=reduce)
    xt = torch.tensor(x, requires_grad=True)
    out = tm(dict({k: torch.as_tensor(v) for k, v in data.items()}, f=xt))["o"]
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **MODULE_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), **MODULE_TOL)
    assert (out[2:] == 0).all()
    # three-way ties in columns 0-1, two-way in 2-4; padded rows get nothing
    np.testing.assert_allclose(xt.grad[:3, :2].numpy(), np.tile(cot[0, :2] / 3, (3, 1)), rtol=1e-6)
    np.testing.assert_allclose(xt.grad[:2, 2:].numpy(), np.tile(cot[0, 2:] / 2, (2, 1)), rtol=1e-6)
    assert float(xt.grad[6:8].abs().sum()) == 0


def test_instance_norm_matches_jax_and_stays_finite_on_padding():
    irreps = "4x0e+2x0o+2x1o+2x2e"
    rng = np.random.default_rng(2)
    n, g = 12, 4
    x = rng.normal(size=(n, Irreps(irreps).dim)).astype(np.float32) * 3.0 + 1.0
    batch = np.asarray([0] * 4 + [1] * 5 + [3] * 3, np.int32)
    mask = np.asarray([1] * 9 + [0] * 3, bool)  # graph 3 all padding, graph 2 empty
    jm = JaxInstanceNorm(irreps=JaxIrreps(irreps))
    args = (jnp.asarray(x), jnp.asarray(batch), g)
    variables = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, mask=jnp.asarray(mask))), 3)
    ref = np.asarray(jm.apply(variables, *args, mask=jnp.asarray(mask)))
    tm = IrrepsInstanceNorm(Irreps(irreps))
    tm.load_state_dict(flax_to_state_dict(variables, tm))
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt, torch.as_tensor(batch), g, mask=torch.as_tensor(mask))
    np.testing.assert_allclose(out.detach().numpy(), ref, **MODULE_TOL)
    (out * torch.as_tensor(mask)[:, None]).sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(xt.grad).all()


def test_norm_activation_matches_jax():
    # the norm plan of a conv layer: scalars and non-scalars, no gates
    info = ActivationInfo(Irreps("4x0e+2x1o"), Irreps("0e+1o+2e"), Irreps("4x0o+4x0e+2x1o+2x1e+2x2e"),
                          activation_type="norm")
    assert not info.irreps_gates and info.irreps_in == info.irreps_out
    rng = np.random.default_rng(4)
    x = rng.normal(size=(9, info.irreps_in.dim)).astype(np.float32)
    x[0] = 0.0  # zero channels: n = eps
    ref = np.asarray(JaxNormActivation(irreps=JaxIrreps(str(info.irreps_in)), act="silu").apply({}, jnp.asarray(x)))
    act = info.make()
    assert isinstance(act, NormActivation)
    np.testing.assert_allclose(act(torch.as_tensor(x)).numpy(), ref, **MODULE_TOL)


def test_gaussian_basis_matches_jax_and_masks_padding():
    rng = np.random.default_rng(5)
    e = 40
    vec = rng.normal(size=(e, 3)).astype(np.float32) * 2.0
    emask = np.arange(e) < 33
    vec[~emask] = 0.0  # padding edges: zero length
    data = {K.EDGE_VECTORS: vec, K.EDGE_MASK: emask}
    irreps = {K.POSITIONS: JaxIrreps("1o")}
    jm = JaxEdgeLengthEmbedding(irreps_in=freeze_irreps(irreps), num_basis=8, basis="gaussian")
    ref = np.asarray(jm.apply({}, {k: jnp.asarray(v) for k, v in data.items()})[K.EDGE_EMBEDDING])
    tm = EdgeLengthEmbedding({K.POSITIONS: Irreps("1o")}, num_basis=8, basis="gaussian")
    out = tm({k: torch.as_tensor(v) for k, v in data.items()})[K.EDGE_EMBEDDING].numpy()
    np.testing.assert_allclose(out, ref, **MODULE_TOL)
    assert (out[~emask] == 0).all() and (out[emask] != 0).any()


def test_species_embedding_with_features_matches_jax():
    data, _ = _graphs(seed=6)
    irreps = {K.POSITIONS: JaxIrreps("1o")}
    kw = dict(allowed_species=SPECIES, embedding_dim=4, use_atom_feats=True, atom_feats_dim=ATOM_F,
              use_global_feats=True, global_feats_dim=GLOBAL_F)
    jm = JaxSpeciesEmbedding(irreps_in=freeze_irreps(irreps), **kw)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd)), 7)
    ref = np.asarray(jm.apply(variables, jd)[JK.NODE_FEATURES])
    tm = SpeciesEmbedding({K.POSITIONS: Irreps("1o")}, generator=torch.Generator(), **kw)
    tm.load_state_dict(flax_to_state_dict(variables, tm))
    assert tm.irreps_out[K.NODE_FEATURES] == Irreps(f"{4 + ATOM_F + GLOBAL_F}x0e")
    out = tm({k: torch.as_tensor(v) for k, v in data.items()})[K.NODE_FEATURES].detach().numpy()
    assert out.shape == (data[K.NODE_MASK].shape[0], 4 + ATOM_F + GLOBAL_F)
    np.testing.assert_allclose(out, ref, **MODULE_TOL)
    assert (out[~data[K.NODE_MASK], 4 + ATOM_F:] == 0).all()


# ---------------------------------------------------------------- models


def _pair(name, seed=0):
    """(JAX model, its filled variables, the port model holding them, batch)."""
    hp = dict(BASE, **CASES[name])
    data, targets = _graphs(seed)
    jm = jax_create_model(hp, DS)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd)), seed + 11)
    tm = create_scalar_tensor_model(hp, DS, device="cpu")
    sd = flax_to_state_dict(variables, tm)
    assert len(sd) == len(tm.state_dict()) == len(jax.tree_util.tree_leaves(variables))
    tm.load_state_dict(sd)
    return jm, variables, tm, (data, targets)


def _as_dict(out, name):
    return out if isinstance(out, dict) else {name: out}


@pytest.mark.parametrize("name", list(CASES))
def test_model_variant_matches_jax(name):
    jm, variables, tm, (data, _) = _pair(name)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    ref = _as_dict(jax.jit(lambda v, d: jm.apply(v, d, use_running_average=True))(variables, jd), TARGET)
    with torch.inference_mode():
        out = _as_dict(tm.eval()({k: torch.as_tensor(v) for k, v in data.items()}), TARGET)
    assert sorted(out) == sorted(ref)
    real = data[K.GRAPH_MASK]
    for k in ref:
        assert tuple(out[k].shape) == tuple(ref[k].shape) and torch.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k].numpy()[real], np.asarray(ref[k])[real], **MODEL_TOL, err_msg=k)


def test_gaussian_model_ignores_edge_padding():
    """Padding the same crystals to a larger edge count changes no real
    output: the padding edges' gaussian values are zeroed by the edge mask."""
    rng = np.random.default_rng(8)
    graphs = []
    for _ in range(3):
        k = int(rng.integers(3, 6))
        s = PortStructure(np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2, rng.uniform(0, 1, (k, 3)),
                          rng.choice(SPECIES, k))
        graphs.append(PortCrystalGraph.from_structure(s, r_cut=5.0))
    nodes, edges = sum(g.num_nodes for g in graphs), sum(g.edge_index.shape[1] for g in graphs)
    model = create_scalar_tensor_model(dict(BASE, radial_basis_type="gaussian", reduce="max",
                                            normalization="instance"), DS, device="cpu").eval()
    outs = []
    for extra in (8, 512):
        data, _ = port_collate(graphs, PortPadSpec(nodes + 3, edges + extra, 4),
                               species_map=atomic_number_map(SPECIES))
        with torch.inference_mode():
            outs.append(model({k: torch.as_tensor(v) for k, v in data.items()})[:3])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- gradients


def _tasks(task_cls, hp):
    weights = {TARGET: 1.0, "k_voigt": 0.5}
    names = [TARGET] + list(hp.get("scalar_target_names", ()))
    return [task_cls(name=n, loss_weight=weights[n], metric_weight=weights[n]) for n in names]


@pytest.mark.parametrize("name", ["instance_norm", "norm_activation", "max_pool", "all"])
def test_train_step_gradients_match_jax(name):
    """One train-mode forward and backward of the masked (and, for "all",
    weighted two-task) loss: the JAX trainer's `_compute_loss` under
    `jax.value_and_grad` against the port trainer's."""
    jm, variables, tm, (data, targets) = _pair(name, seed=1)
    hp = dict(BASE, **CASES[name])
    if name != "all":
        data = {k: v for k, v in data.items() if k != "target_weight"}
    jt = JaxTrainer(jm, _tasks(JaxTask, hp), JaxConfig(lr=0.01, scheduler="none"))
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    jtg = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(params):
        v = dict(variables, params=params)
        if "batch_stats" in variables:
            out, _ = jm.apply(v, jd, mutable=["batch_stats"], use_running_average=False)
        else:
            out = jm.apply(v, jd, use_running_average=False)
        return jt._compute_loss(_as_dict(out, TARGET), jd, jtg)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    ref = flax_to_state_dict(dict(variables, params=jgrads), tm)

    pt = Trainer(tm, _tasks(CanonicalRegressionTask, hp), TrainerConfig(lr=0.01), device="cpu")
    d, t = batch_to_device(data, "cpu", targets)
    pt.model.train()
    loss = pt._compute_loss(pt._preds(d), d, t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = {n: p.grad for n, p in pt.model.named_parameters()}
    assert grads and all(g is not None and torch.isfinite(g).all() for g in grads.values())
    for n, g in grads.items():
        r = ref[n].numpy()
        scale = max(float(np.abs(r).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, r / scale, rtol=0, atol=1e-4, err_msg=n)
