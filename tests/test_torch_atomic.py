"""The port's per-atom NMR model against the JAX package on the CPU.

Small widths (SH lmax 2, `ij=ji` targets, 2 conv layers; 1 for the train
step), three crystals over O and Si with a per-atom `nmr_tensor` and an
`atom_selector` that marks the Si atoms. The JAX side fills its parameter
layout with seeded numpy values and runs jitted on the CPU; the port model
gets the same values through `convert.flax_to_state_dict`. Tolerances:
`NodewiseSelect` exact; the model's output on the real nodes rtol=atol=1e-4
(float32 with another summation order, through the convs and batch norm),
its running statistics after a train-mode forward rtol=atol=1e-5; the
per-atom SGD step's gradients atol 1e-4 after scaling each parameter by
its max |ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matten_tpu.data import keys as K
from matten_tpu.data.graph import CrystalGraph, collate_graphs, pad_spec_for
from matten_tpu.data.structure import Structure
from matten_tpu.models import create_atomic_tensor_model as jax_create_model
from matten_tpu.nn.common import freeze_irreps
from matten_tpu.nn.nodewise import NodewiseSelect as JaxNodewiseSelect
from matten_tpu.ops.irreps import Irreps
from matten_tpu.train import CanonicalRegressionTask as JaxTask
from matten_tpu.train import Trainer as JaxTrainer
from matten_tpu.train import TrainerConfig as JaxConfig
from matten_tpu_torch.convert import flax_to_state_dict
from matten_tpu_torch.models import AtomicTensorModel, create_atomic_tensor_model
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.nn.nodewise import NodewiseSelect
from matten_tpu_torch.predict import batch_to_device
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig

torch.set_num_threads(2)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
SPECIES = (8, 14)
TARGET = "nmr_tensor"
HPARAMS = dict(
    species_embedding_dim=8,
    irreps_edge_sh="0e+1o+2e",
    num_radial_basis=8,
    num_layers=2,
    invariant_layers=2,
    invariant_neurons=8,
    average_num_neighbors=20.0,
    conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+1x2o+1x2e",
    nonlinearity_type="gate",
    normalization="batch",
    output_format="irreps",
    output_formula="ij=ji",
)
DS = dict(allowed_species=list(SPECIES), average_num_neighbors=20.0)


def _batch(seed=0, n=3):
    """Collated (data, targets): per-atom targets [N_pad, 6] and a bool
    atom_selector marking the Si atoms (O atoms carry no target)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        k = int(rng.integers(3, 6))
        z = rng.choice(SPECIES, size=k)
        z[0] = 14  # at least one selected atom per crystal
        g = CrystalGraph.from_structure(
            Structure(
                lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2,
                frac_coords=rng.uniform(0, 1, size=(k, 3)),
                atomic_numbers=z,
            ),
            r_cut=5.0,
        )
        sel = z == 14
        g.y[TARGET] = np.where(sel[:, None], rng.normal(size=(k, 6)), 0.0)
        g.y["atom_selector"] = sel
        graphs.append(g)
    return collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(SPECIES))


def _fill(tree, seed, scale=1.0):
    """Seeded values in a flax layout (positive running_var)."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        if "running_var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return (scale * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, tree)


def test_nodewise_select_matches_jax():
    rng = np.random.default_rng(1)
    irreps = {K.NODE_FEATURES: Irreps("3x0e+2x1o"), K.ATOM_SELECTOR: None}
    data = {
        K.NODE_FEATURES: rng.normal(size=(9, 9)).astype(np.float32),
        K.ATOM_SELECTOR: rng.uniform(size=9) < 0.5,
    }
    jm = JaxNodewiseSelect(irreps_in=freeze_irreps(irreps))
    ref = jm.apply({}, {k: jnp.asarray(v) for k, v in data.items()})
    tm = NodewiseSelect(irreps)
    out = tm({k: torch.as_tensor(v) for k, v in data.items()})
    assert tm.out_field == "selected_node_features" and tm.out_field in ref
    assert {k: str(v) for k, v in tm.irreps_out.items()} == {
        k: str(v) for k, v in dict(jm.irreps_out).items()}
    np.testing.assert_array_equal(out[tm.out_field].numpy(), np.asarray(ref[tm.out_field]))
    assert not out[tm.out_field][~torch.as_tensor(data[K.ATOM_SELECTOR])].any()


@pytest.fixture(scope="module")
def case():
    """The JAX atomic model in eval and train mode on the batch, and the
    port model loaded with the same (converted) variables."""
    data, _ = _batch()
    jm = jax_create_model(HPARAMS, DS)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd)), seed=3)
    ref = np.asarray(jax.jit(lambda v, d: jm.apply(v, d, use_running_average=True))(variables, jd))
    train_ref, updated = jax.jit(
        lambda v, d: jm.apply(v, d, use_running_average=False, mutable=["batch_stats"])
    )(variables, jd)
    model = create_atomic_tensor_model(HPARAMS, DS, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, model))
    return dict(data=data, variables=variables, model=model, ref=ref,
                train_ref=np.asarray(train_ref), updated=updated)


def test_convert_covers_every_atomic_leaf(case):
    variables, model = case["variables"], case["model"]
    assert isinstance(model, AtomicTensorModel) and "w_out" not in variables["params"]
    layers = variables["params"]["backbone"]
    # the head is the backbone's NodewiseLinear after 3 embeddings and the
    # convs, its last layer: no pooling after it
    head = 4 + HPARAMS["num_layers"]
    assert sorted(layers, key=lambda k: int(k.split("_")[1]))[-1] == f"layers_{head}"
    assert tuple(model.state_dict()[f"backbone.layers.{head}.w"].shape) == layers[f"layers_{head}"]["w"].shape
    leaves = jax.tree_util.tree_leaves(variables)
    assert len(leaves) == len(flax_to_state_dict(variables, model)) == len(model.state_dict())
    shifted = {
        "params": {"backbone": {(f"layers_{head + 1}" if k == f"layers_{head}" else k): v
                                for k, v in layers.items()}},
        "batch_stats": variables["batch_stats"],
    }
    with pytest.raises(KeyError):
        flax_to_state_dict(shifted, model)


def test_atomic_model_matches_jax_in_eval_mode(case):
    model = case["model"].eval()
    with torch.inference_mode():
        out = model({k: torch.as_tensor(v) for k, v in case["data"].items()})
    real = case["data"][K.NODE_MASK]
    assert out.shape == case["ref"].shape == (len(real), 6)
    np.testing.assert_allclose(out.numpy()[real], case["ref"][real], **MODEL_TOL)


def test_atomic_model_matches_jax_in_train_mode(case):
    """Batch statistics over the real nodes, and the running statistics
    they update."""
    model = create_atomic_tensor_model(HPARAMS, DS, device="cpu")
    model.load_state_dict(flax_to_state_dict(case["variables"], model))
    model.train()
    with torch.no_grad():
        out = model({k: torch.as_tensor(v) for k, v in case["data"].items()})
    real = case["data"][K.NODE_MASK]
    np.testing.assert_allclose(out.numpy()[real], case["train_ref"][real], **MODEL_TOL)
    got = model.state_dict()
    ref = flax_to_state_dict({"params": case["variables"]["params"], **case["updated"]}, model)
    names = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * HPARAMS["num_layers"]
    for k in names:
        assert not torch.equal(got[k], flax_to_state_dict(case["variables"], model)[k]), k
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), err_msg=k, **STATS_TOL)


def test_per_atom_sgd_gradients_match_jax():
    """One SGD step's gradients of the masked per-atom MSE (real Si atoms
    only) against the JAX `Trainer` with a per-atom task."""
    hp = dict(HPARAMS, num_layers=1, invariant_layers=1)
    data, targets = _batch(seed=5, n=4)
    sel = targets["atom_selector"]
    assert sel.dtype == bool and 0 < sel.sum() < data[K.NODE_MASK].sum()
    cfg = dict(lr=0.01, optimizer="sgd", scheduler="none")
    jt = JaxTrainer(jax_create_model(hp, DS), [JaxTask(name=TARGET, per_atom=True)], JaxConfig(**cfg))
    state = jt.init_state((data, targets))
    params, stats = _fill(state.params, 6, scale=0.5), _fill(state.batch_stats, 7)
    state = state.replace(params=params, batch_stats=stats, opt_state=jt.tx.init(params))
    jgrads, jloss, _, _ = jax.jit(jt._grads_and_metrics)(state, data, targets)

    model = create_atomic_tensor_model(hp, DS, device="cpu")
    model.load_state_dict(flax_to_state_dict({"params": params, "batch_stats": stats}, model))
    pt = Trainer(model, [CanonicalRegressionTask(name=TARGET, per_atom=True)], TrainerConfig(**cfg),
                 device="cpu")
    d, t = batch_to_device(data, "cpu", targets)
    pt.model.train()
    loss = pt._compute_loss(pt._preds(d), d, t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref = flax_to_state_dict({"params": jgrads, "batch_stats": stats}, model)
    names = [n for n, _ in pt.model.named_parameters()]
    assert names
    for name, p in pt.model.named_parameters():
        r = ref[name].numpy()
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(p.grad.numpy() / scale, r / scale, atol=1e-4, err_msg=name)
