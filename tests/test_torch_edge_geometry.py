"""Edge vectors in the graph, and the position-gradient contract, against
the JAX package on the CPU.

A model built with `require_position_gradients` refuses batches whose edge
vectors were precomputed at collation, in the port as in the JAX package.
Batches collated with `precompute_edge_vectors=False` carry no edge vectors;
the port computes them from the positions (vec = pos[dst] - pos[src] +
shift @ cell), and its forward and its gradient with respect to the
positions match the JAX in-graph path within 1e-5, max|d| relative to
max|ref| (a one-layer model, SH lmax 2, eval mode, float32). The gradient is
compared on the real nodes: a padding node's only edge is a zero-length
self loop, where the JAX norm's gradient is not defined.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matten_tpu.data import keys as JK
from matten_tpu.data.graph import CrystalGraph as JaxGraph
from matten_tpu.data.graph import collate_graphs as jax_collate
from matten_tpu.data.graph import pad_spec_for as jax_pad_spec
from matten_tpu.data.structure import Structure as JaxStructure
from matten_tpu.models import create_scalar_tensor_model as jax_create_model
from matten_tpu_torch.convert import flax_to_state_dict
from matten_tpu_torch.data import keys as K
from matten_tpu_torch.data.datamodule import BatchLoader
from matten_tpu_torch.data.graph import CrystalGraph
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.nn.edge_geometry import with_edge_vectors
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.predict import batch_to_device
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig

torch.set_num_threads(2)

SPECIES = (8, 14)
TARGET = "elastic_tensor_full"
HPARAMS = dict(
    species_embedding_dim=8,
    irreps_edge_sh="0e+1o+2e",
    num_radial_basis=8,
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
GRAD_HPARAMS = dict(HPARAMS, require_position_gradients=True)
DS = dict(allowed_species=list(SPECIES), average_num_neighbors=20.0)
TOL = 1e-5


def _structures(seed=0, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 5))
        out.append((np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2, rng.uniform(0, 1, size=(k, 3)),
                    rng.choice(SPECIES, size=k)))
    return out


def _jax_batch(precompute):
    graphs = [JaxGraph.from_structure(JaxStructure(*s), r_cut=5.0) for s in _structures()]
    for i, g in enumerate(graphs):
        g.y[TARGET] = np.full((1, 21), 0.1 * i)
    return jax_collate(graphs, jax_pad_spec(graphs), species_map=atomic_number_map(SPECIES),
                       precompute_edge_vectors=precompute)


def _rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_precomputed_vectors_raise_when_position_gradients_required():
    data, _ = _jax_batch(precompute=True)
    assert K.EDGE_VECTORS in data
    model = create_scalar_tensor_model(GRAD_HPARAMS, DS, device="cpu")
    with pytest.raises(ValueError, match="position gradients"):
        model(batch_to_device(data, "cpu"))
    # the JAX model refuses the same batch
    with pytest.raises(ValueError, match="position gradients"):
        jax_create_model(GRAD_HPARAMS, DS).init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in data.items()})
    # without the flag the precomputed vectors are used
    out = create_scalar_tensor_model(HPARAMS, DS, device="cpu").eval()(batch_to_device(data, "cpu"))
    assert bool(torch.isfinite(out).all())


def test_in_graph_vectors_equal_the_precomputed_ones():
    pre, _ = _jax_batch(precompute=True)
    data, _ = _jax_batch(precompute=False)
    assert K.EDGE_VECTORS not in data
    d = batch_to_device(data, "cpu")
    with_edge_vectors(d, require_position_gradients=True)
    np.testing.assert_allclose(d[K.EDGE_VECTORS].numpy(), pre[K.EDGE_VECTORS], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(d[K.EDGE_VECTORS].numpy()[~data[K.EDGE_MASK]], 0.0)
    np.testing.assert_allclose(d[K.EDGE_LENGTH].numpy(), np.linalg.norm(pre[K.EDGE_VECTORS], axis=-1),
                               rtol=1e-5, atol=1e-5)


def test_forward_and_position_gradient_match_jax():
    data, _ = _jax_batch(precompute=False)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    jm = jax_create_model(GRAD_HPARAMS, DS)
    rng = np.random.default_rng(3)

    def fill(path, s):
        if "running_var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return (0.5 * rng.normal(size=s.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd)))
    weights = rng.normal(size=(data[JK.GRAPH_MASK].shape[0], 21)).astype(np.float32)
    weights[~data[JK.GRAPH_MASK]] = 0.0

    def objective(pos):
        out = jm.apply(variables, dict(jd, pos=pos), use_running_average=True)
        return jnp.sum(out * weights), out

    (_, ref), ref_grad = jax.jit(jax.value_and_grad(objective, has_aux=True))(jd["pos"])

    model = create_scalar_tensor_model(GRAD_HPARAMS, DS, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, model))
    d = batch_to_device(data, "cpu")
    d[K.POSITIONS].requires_grad_(True)
    out = model.eval()(d)
    (out * torch.as_tensor(weights)).sum().backward()
    real, nodes = data[K.GRAPH_MASK], data[K.NODE_MASK]
    assert _rel(out.detach().numpy()[real], np.asarray(ref)[real]) <= TOL
    grad, ref_grad = d[K.POSITIONS].grad.numpy()[nodes], np.asarray(ref_grad)[nodes]
    assert np.abs(ref_grad).max() > 0
    assert _rel(grad, ref_grad) <= TOL


def test_model_trains_on_batches_without_vectors():
    """The loader knob keeps EDGE_VECTORS out of the batches; a model that
    needs position gradients trains on them."""
    graphs = [CrystalGraph.from_structure(Structure(*s), r_cut=5.0) for s in _structures(seed=4, n=8)]
    for g in graphs:
        g.y[TARGET] = np.ones((1, 21))
    loader = BatchLoader(graphs, batch_size=4, species_map=atomic_number_map(SPECIES),
                         precompute_edge_vectors=False)
    data, targets = next(iter(loader))
    assert K.EDGE_VECTORS not in data
    trainer = Trainer(create_scalar_tensor_model(GRAD_HPARAMS, DS, device="cpu"),
                      [CanonicalRegressionTask(name=TARGET)], TrainerConfig(lr=0.01), device="cpu")
    losses = [float(trainer.train_step(*batch_to_device(data, "cpu", targets))[0]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_position_gradients_after_an_inference_forward():
    """The SH recursion tables and the TP plans' CG tables are cached per
    device; a serving forward under `torch.inference_mode()` that fills the
    caches first must not leave inference tensors there, which a later
    forward with position gradients would have to save for its backward."""
    from matten_tpu_torch.ops import spherical_harmonics as sh_module

    sh_module._recursion_table.cache_clear()
    model = create_scalar_tensor_model(dict(GRAD_HPARAMS, irreps_edge_sh="0e+1o+2e+3o"), DS, device="cpu")
    graphs = [CrystalGraph.from_structure(Structure(*s), r_cut=5.0) for s in _structures(seed=5)]
    data, _ = BatchLoader(graphs, batch_size=3, species_map=atomic_number_map(SPECIES),
                          precompute_edge_vectors=False).__iter__().__next__()
    with torch.inference_mode():
        served = model.eval()(batch_to_device(data, "cpu"))
    d = batch_to_device(data, "cpu")
    d[K.POSITIONS].requires_grad_(True)
    out = model(d)
    (grad,) = torch.autograd.grad(out[d[K.GRAPH_MASK]].square().sum(), d[K.POSITIONS])
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0
    np.testing.assert_allclose(out.detach().numpy(), served.numpy(), rtol=1e-6, atol=1e-6)
