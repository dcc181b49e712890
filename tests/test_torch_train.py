"""The port's train step against the JAX `Trainer` on the CPU.

A one-layer model (SH lmax 2, and for the SGD steps once more with SH
lmax 5 and l=5 conv irreps; batch norm) on four small crystals with
seeded targets. The JAX side fills its parameter layout with seeded numpy
values and runs its jitted step (xla tier); the port's model is loaded with
the same values through `convert.flax_to_state_dict`. Tolerances: first-step
gradients atol 1e-4 after scaling each parameter by its max |ref|; running
statistics after a step rtol=atol=1e-5; parameters after 3 SGD steps
rtol=atol=1e-4; the loss over 5 Adam steps 1e-3 relative.
"""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from matten_tpu.data.graph import CrystalGraph, collate_graphs, pad_spec_for
from matten_tpu.data.structure import Structure
from matten_tpu.data.transform import MeanNormNormalize
from matten_tpu.models import create_scalar_tensor_model as jax_create_model
from matten_tpu.train import CanonicalRegressionTask as JaxTask
from matten_tpu.train import Trainer as JaxTrainer
from matten_tpu.train import TrainerConfig as JaxConfig
from matten_tpu.train.trainer import ReduceLROnPlateau as JaxPlateau
from matten_tpu_torch.data.transform import MeanNormNormalize as PortNormalize
from matten_tpu_torch.convert import flax_to_state_dict
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.predict import batch_to_device
from matten_tpu_torch.train import CanonicalRegressionTask, Trainer, TrainerConfig
from matten_tpu_torch.train.task import masked_abs_err_sum
from matten_tpu_torch.train.trainer import ReduceLROnPlateau

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _two_blas_threads():
    """The l=5 CG blocks are SVDs of matrices up to 4000 x 1331 (the JAX
    package's `wigner_3j`). Under the suite's parallel workers, OpenBLAS
    threads that spin on every core slow them a hundredfold; two threads
    per worker keep them near their single-process time (and converge for
    every l <= 5 block, which one thread does not for (2, 4, 4))."""
    with threadpool_limits(limits=2, user_api="blas"):
        yield

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
DS = dict(allowed_species=list(SPECIES), average_num_neighbors=20.0)
# above l=4: SH up to 5o and 5o / 5e conv irreps
HPARAMS_L5 = dict(HPARAMS, irreps_edge_sh="0e+1o+2e+3o+4e+5o",
                  conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+2x2e+1x5o+1x5e")


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        k = int(rng.integers(3, 6))
        g = CrystalGraph.from_structure(
            Structure(
                lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2,
                frac_coords=rng.uniform(0, 1, size=(k, 3)),
                atomic_numbers=rng.choice(SPECIES, size=k),
            ),
            r_cut=5.0,
        )
        g.y[TARGET] = rng.normal(size=(1, 21))
        graphs.append(g)
    return collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(SPECIES))


def _fill(tree, seed):
    """Seeded values in a flax layout: N(0, 0.5) parameters, positive running_var."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        if "running_var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return (0.5 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, tree)


def _pair(optimizer, lr, hparams=HPARAMS):
    """A JAX trainer + state and a port trainer holding the same values."""
    data, targets = _batch()
    cfg = dict(lr=lr, optimizer=optimizer, scheduler="none")
    jt = JaxTrainer(jax_create_model(hparams, DS), [JaxTask(name=TARGET)], JaxConfig(**cfg))
    state = jt.init_state((data, targets))
    params = _fill(state.params, 1)
    stats = _fill(state.batch_stats, 2)
    state = state.replace(params=params, batch_stats=stats, opt_state=jt.tx.init(params))
    model = create_scalar_tensor_model(hparams, DS, device="cpu")
    model.load_state_dict(flax_to_state_dict({"params": params, "batch_stats": stats}, model))
    pt = Trainer(model, [CanonicalRegressionTask(name=TARGET)], TrainerConfig(**cfg), device="cpu")
    return jt, state, pt, (data, targets), batch_to_device(data, "cpu", targets)


def _as_state_dict(tree, stats, model):
    return flax_to_state_dict({"params": tree, "batch_stats": stats}, model)


@pytest.fixture(scope="module", params=[HPARAMS, HPARAMS_L5], ids=["lmax2", "l5"])
def sgd(request):
    """Gradients, statistics and parameters of the JAX and port SGD steps."""
    jt, state, pt, (data, targets), (d, t) = _pair("sgd", 0.01, request.param)
    jgrads, jloss, _, jmetrics = jax.jit(jt._grads_and_metrics)(state, data, targets)
    pt.model.train()
    loss = pt._compute_loss(pt._preds(d), d, t)
    loss.backward()
    pgrads = {n: p.grad.clone() for n, p in pt.model.named_parameters()}
    ref_grads = _as_state_dict(jgrads, state.batch_stats, pt.model)

    # the step itself (fresh port trainer, same values), three times
    jt, state, pt, (data, targets), (d, t) = _pair("sgd", 0.01, request.param)
    step = jax.jit(jt._train_step)
    out = {"steps": []}
    for i in range(3):
        state, jl, jm = step(state, data, targets)
        pl, pm = pt.train_step(d, t)
        out["steps"].append((float(jl), float(pl), jm, pm))
        if i == 0:
            out["stats_1"] = (
                _as_state_dict(state.params, state.batch_stats, pt.model),
                {k: v.clone() for k, v in pt.model.state_dict().items()},
            )
    out.update(
        grads=(pgrads, ref_grads), loss0=(float(loss.detach()), float(jloss)), metrics0=jmetrics,
        params_3=(_as_state_dict(state.params, state.batch_stats, pt.model), pt.model.state_dict()),
    )
    return out


def test_first_step_gradients_match_jax(sgd):
    pgrads, ref = sgd["grads"]
    np.testing.assert_allclose(*sgd["loss0"], rtol=1e-5)
    assert pgrads and set(pgrads) <= set(ref)
    for name, g in pgrads.items():
        r = ref[name].numpy()
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g.numpy() / scale, r / scale, atol=1e-4, err_msg=name)


def test_running_stats_after_a_step_match_jax(sgd):
    ref, got = sgd["stats_1"]
    names = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


def test_params_after_three_sgd_steps_match_jax(sgd):
    ref, got = sgd["params_3"]
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    for jl, pl, jm, pm in sgd["steps"]:
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        (js, jc), (ps, pc) = jm[TARGET], pm[TARGET]
        np.testing.assert_allclose(float(ps), float(js), rtol=1e-5)
        assert float(pc) == float(jc) == 4 * 21


def test_adam_loss_trajectory_matches_jax():
    jt, state, pt, (data, targets), (d, t) = _pair("adam", 0.01)
    step = jax.jit(jt._train_step)
    jl, pl = [], []
    for _ in range(5):
        state, loss, _ = step(state, data, targets)
        jl.append(float(loss))
        pl.append(float(pt.train_step(d, t)[0]))
    np.testing.assert_allclose(pl, jl, rtol=1e-3)
    assert pl[-1] < pl[0]


def test_plateau_scheduler_matches_jax():
    scores = [5.0, 4.0, 4.0, 4.5, 4.1, 3.9, 3.9, 3.95, 4.0, 4.0, 4.0, 3.0, 3.5, 3.5, 3.5, 3.5]
    j, p = JaxPlateau(factor=0.5, patience=2), ReduceLROnPlateau(factor=0.5, patience=2)
    jr = [j.step(s) for s in scores]
    pr = [p.step(s) for s in scores]
    assert pr == jr and sum(pr) >= 2
    assert (p.scale, p.best, p.num_bad) == (j.scale, j.best, j.num_bad)


def test_set_lr_and_eval_step():
    _, _, pt, _, (d, t) = _pair("adam", 0.01)
    pt.set_lr(0.005)
    assert all(g["lr"] == 0.005 for g in pt.optimizer.param_groups)
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    loss, metrics = pt.eval_step(d, t)
    assert torch.isfinite(loss) and not pt.model.training
    after = pt.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert float(metrics[TARGET][1]) == 4 * 21


def test_metric_sums_denormalize_as_jax():
    """A task with a target normalizer takes the MAE in target units, as
    the JAX task's `transform_for_metric` does."""
    import jax.numpy as jnp

    from matten_tpu.train.task import masked_abs_err_sum as jax_abs_err_sum

    rng = np.random.default_rng(9)
    mean, norm = rng.normal(size=21), rng.uniform(0.5, 2.0, 21)
    pred, target = rng.normal(size=(2, 6, 21)).astype(np.float32)
    mask = np.arange(6) < 4
    jtask = JaxTask(name=TARGET, normalizer=MeanNormNormalize("2x0e+2x2e+4e", mean=mean, norm=norm))
    ptask = CanonicalRegressionTask(name=TARGET, normalizer=PortNormalize("2x0e+2x2e+4e", mean=mean, norm=norm))
    js, jc = jax_abs_err_sum(*(jtask.transform_for_metric(jnp.asarray(a)) for a in (pred, target)),
                             jnp.asarray(mask))
    ps, pc = masked_abs_err_sum(*(ptask.transform_for_metric(torch.as_tensor(a)) for a in (pred, target)),
                                torch.as_tensor(mask))
    np.testing.assert_allclose(float(ps), float(js), rtol=1e-6)
    assert float(pc) == float(jc) == 4 * 21
