"""The port's conv modules, whole model and predict() against the JAX package.

Small widths (2 conv layers, SH lmax 2, and once SH lmax 5 with l=5 conv
irreps; 2 crystals). The JAX side gets its
parameter layout from `jax.eval_shape(init)`, filled with seeded numpy
values, runs under jit on the CPU, and the same values reach the port
through `convert.flax_to_state_dict`. Every FCTP branch is covered:
5 species (scalar-matmul form), 16 and 73 species (plain contraction times
the node mask), and 73 species with `MATTEN_ONEHOT_GATHER_MIN_S=16` set for
both packages (the weight gather, `apply_onehot2`). Tolerances: modules rtol=atol=1e-5; the whole model and
predict() rtol=atol=1e-4 (float32 with another summation order, carried
through the convs and batch norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from matten_tpu.data import keys as K
from matten_tpu.data.graph import CrystalGraph, collate_graphs, pad_spec_for
from matten_tpu.data.structure import Structure
from matten_tpu.data.transform import MeanNormNormalize
from matten_tpu.models import create_scalar_tensor_model as jax_create_model
from matten_tpu.nn.common import freeze_irreps
from matten_tpu.nn.conv import PointConv as JaxPointConv
from matten_tpu.nn.conv import PointConvWithActivation as JaxPointConvWithActivation
from matten_tpu.ops.cartesian import cartesian_tensor_map
from matten_tpu.ops.irreps import Irreps
from matten_tpu_torch.convert import flax_to_state_dict
from matten_tpu_torch.data.structure import Structure as PortStructure
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.nn.conv import PointConv, PointConvWithActivation
from matten_tpu_torch.nn.embedding import atomic_number_map
from matten_tpu_torch.ops.tensor_product import TensorProductPlan
from matten_tpu_torch.predict import predict

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

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
CONV_IRREPS = "4x0o+4x0e+2x1o+2x1e+1x2o+1x2e"
HPARAMS = dict(
    species_embedding_dim=8,
    irreps_edge_sh="0e+1o+2e",
    num_radial_basis=8,
    num_layers=2,
    invariant_layers=2,
    invariant_neurons=8,
    average_num_neighbors=30.0,
    conv_layer_irreps=CONV_IRREPS,
    nonlinearity_type="gate",
    normalization="batch",
    conv_to_output_hidden_irreps_out="4x0e+2x2e+4e",
    output_format="irreps",
    output_formula="ijkl=jikl=klij",
    reduce="mean",
)
SPECIES = {5: (8, 13, 14, 22, 56), 16: tuple(range(3, 19)), 73: tuple(range(3, 76))}
# the species count from which both packages' convs gather the species
# FCTPs' weights (`apply_onehot2`) in the "S73-gather" case
GATHER_VAR, GATHER_MIN_S = "MATTEN_ONEHOT_GATHER_MIN_S", 16
# above l=4: SH up to 5o and 5o / 5e conv irreps (the conv kernels' generic
# paths on the card), 5 species
HPARAMS_L5 = dict(HPARAMS, irreps_edge_sh="0e+1o+2e+3o+4e+5o", conv_layer_irreps=CONV_IRREPS + "+1x5o+1x5e")


def _fill(shapes, seed):
    """Seeded numpy values in a flax variable layout (positive running_var)."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        if "running_var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _structures(species, n=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 5))
        out.append(
            Structure(
                lattice=np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1,
                frac_coords=rng.uniform(0, 1, size=(k, 3)),
                atomic_numbers=rng.choice(species, size=k),
            )
        )
    return out


def _load(module, variables):
    module.load_state_dict(flax_to_state_dict(variables, module))
    return module.eval()


# ---------------------------------------------------------------- modules


def _module_inputs(s, seed, n=12, e=60):
    rng = np.random.default_rng(seed)
    feats, sh = Irreps("6x0e+2x1o"), Irreps("0e+1o+2e")
    mask = np.arange(n) < n - 2  # two padded nodes
    onehot = np.eye(s, dtype=np.float32)[rng.integers(0, s, n)] * mask[:, None]
    data = {
        K.NODE_FEATURES: rng.normal(size=(n, feats.dim)).astype(np.float32),
        K.NODE_ATTRS: onehot,
        K.EDGE_ATTRS: rng.normal(size=(e, sh.dim)).astype(np.float32),
        K.EDGE_EMBEDDING: rng.normal(size=(e, 8)).astype(np.float32),
        K.EDGE_INDEX: np.stack(
            [rng.integers(0, n - 2, e), np.sort(rng.integers(0, n - 2, e))]
        ).astype(np.int32),
        K.NUM_NEIGH: rng.integers(1, 8, n).astype(np.float32),
        K.NODE_MASK: mask,
    }
    irreps = {
        K.NODE_FEATURES: feats,
        K.NODE_ATTRS: Irreps(f"{s}x0e"),
        K.EDGE_ATTRS: sh,
        K.EDGE_EMBEDDING: Irreps("8x0e"),
    }
    return data, irreps


@pytest.mark.parametrize("s,avg", [(5, 30.0), (16, None)])
def test_point_conv_matches_jax(s, avg):
    data, irreps = _module_inputs(s, seed=s)
    kw = dict(fc_num_hidden_layers=2, fc_hidden_size=8, avg_num_neighbors=avg)
    jm = JaxPointConv(irreps_in=freeze_irreps(irreps), conv_layer_irreps=Irreps(CONV_IRREPS), **kw)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd)), seed=1)
    ref = np.asarray(jax.jit(jm.apply)(variables, jd)[K.NODE_FEATURES])
    tm = _load(PointConv(irreps, CONV_IRREPS, torch.Generator(), **kw), variables)
    with torch.inference_mode():
        out = tm({k: torch.as_tensor(v) for k, v in data.items()})[K.NODE_FEATURES]
    np.testing.assert_allclose(out.numpy(), ref, **MODULE_TOL)


@pytest.mark.parametrize("s,train", [(5, False), (16, False), (5, True)])
def test_point_conv_with_activation_matches_jax(s, train):
    """Eval mode (running statistics) at both FCTP branches, and train mode:
    masked batch statistics and the running-statistics update."""
    data, irreps = _module_inputs(s, seed=10 + s)
    kw = dict(fc_num_hidden_layers=2, fc_hidden_size=8, avg_num_neighbors=30.0)
    jm = JaxPointConvWithActivation(
        irreps_in=freeze_irreps(irreps), conv_layer_irreps=Irreps(CONV_IRREPS),
        normalization="batch", **kw,
    )
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd)), seed=2)
    run = jax.jit(
        lambda v, d: jm.apply(v, d, use_running_average=not train, mutable=["batch_stats"])
    )
    ref, updated = run(variables, jd)
    tm = PointConvWithActivation(irreps, CONV_IRREPS, torch.Generator(), normalization="batch", **kw)
    tm = _load(tm, variables).train(train)
    with torch.no_grad():
        out = tm({k: torch.as_tensor(v) for k, v in data.items()})[K.NODE_FEATURES]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[K.NODE_FEATURES]), **MODULE_TOL)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(
            getattr(tm.norm, name).numpy(),
            np.asarray(updated["batch_stats"]["norm"][name]),
            **MODULE_TOL,
        )


# ---------------------------------------------------------------- model


@pytest.fixture(scope="module", params=[(5, HPARAMS, False), (16, HPARAMS, False), (5, HPARAMS_L5, False),
                                        (73, HPARAMS, False), (73, HPARAMS, True)],
                ids=["S5", "S16", "L5", "S73", "S73-gather"])
def _case(request):
    """JAX model output on a 2-crystal batch, and the port model loaded
    with the same (converted) variables; with `gather`, the JAX model runs
    its species FCTPs as the gather (`apply_onehot2`)."""
    s, hparams, gather = request.param
    species = SPECIES[s]
    ds = dict(allowed_species=list(species), average_num_neighbors=30.0)
    structures = _structures(species)
    graphs = [CrystalGraph.from_structure(st, r_cut=5.0) for st in structures]
    data, _ = collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(species))
    jm = jax_create_model(hparams, ds)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    with pytest.MonkeyPatch.context() as mp:
        if gather:
            mp.setenv(GATHER_VAR, str(GATHER_MIN_S))
        variables = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd)), seed=s)
        ref = np.asarray(jax.jit(lambda v, d: jm.apply(v, d, use_running_average=True))(variables, jd))
    tm = create_scalar_tensor_model(hparams, ds, device="cpu")
    return dict(
        data=data, ref=ref, variables=variables, structures=structures,
        model=_load(tm, variables), gather=gather,
    )


@pytest.fixture
def case(_case, monkeypatch):
    """`_case`, with the port's species FCTPs taking the gather while the
    test runs where the JAX model took it; every `apply_onehot2` call is
    counted in `case["gathers"]`."""
    if _case["gather"]:
        monkeypatch.setenv(GATHER_VAR, str(GATHER_MIN_S))
    calls = []
    gather = TensorProductPlan.apply_onehot2

    def counted(self, *args, **kwargs):
        calls.append(self)
        return gather(self, *args, **kwargs)

    monkeypatch.setattr(TensorProductPlan, "apply_onehot2", counted)
    return dict(_case, gathers=calls)


def test_convert_covers_every_flax_leaf(case):
    variables, model = case["variables"], case["model"]
    leaves = jax.tree_util.tree_leaves(variables)
    sd = flax_to_state_dict(variables, model)
    assert len(leaves) == len(sd) == len(model.state_dict())
    # a shifted Sequential index (e.g. interleaved debug layers) is refused
    shifted = {
        "params": {
            "backbone": {
                ("layers_9" if k == "layers_3" else k): v
                for k, v in variables["params"]["backbone"].items()
            },
            "w_out": variables["params"]["w_out"],
        },
        "batch_stats": variables["batch_stats"],
    }
    with pytest.raises(KeyError):
        flax_to_state_dict(shifted, model)


def test_model_matches_jax(case):
    with torch.inference_mode():
        out = case["model"]({k: torch.as_tensor(v) for k, v in case["data"].items()})
    assert out.shape == case["ref"].shape
    # the gather form takes sc, lin1 and lin2 of every conv layer, and only it
    convs = [m for m in case["model"].modules() if isinstance(m, PointConv)]
    assert len(case["gathers"]) == (3 * len(convs) if case["gather"] else 0)
    real = case["data"][K.GRAPH_MASK]
    np.testing.assert_allclose(out.numpy()[real], case["ref"][real], **MODEL_TOL)


def test_predict_matches_jax(case):
    """predict() on the two crystals == JAX forward -> inverse normalization
    -> Cartesian readout."""
    rng = np.random.default_rng(7)
    cmap = cartesian_tensor_map("ijkl=jikl=klij")
    stats = MeanNormNormalize(
        cmap.irreps, mean=rng.normal(size=21), norm=rng.uniform(0.5, 2.0, 21)
    )
    # a lone atom in a 20 A cell has no neighbours within 5 A: its graph
    # cannot be built and its result is None
    lone = PortStructure(lattice=np.eye(3) * 20.0, frac_coords=[[0, 0, 0]],
                         atomic_numbers=[case["structures"][0].atomic_numbers[0]])
    # the port's own Structure, with the JAX side's values
    first, second = (PortStructure(s.lattice, s.frac_coords, s.atomic_numbers)
                     for s in case["structures"])
    results = predict([first, lone, second], case["model"], statistics=stats)
    assert len(results) == 3 and results[1] is None
    for i, r in enumerate(results[::2]):
        assert r.shape == (3, 3, 3, 3) and np.isfinite(r).all()
        expect = cmap.to_cartesian(stats.inverse(case["ref"][i].astype(np.float64)))
        np.testing.assert_allclose(np.asarray(r), expect, **MODEL_TOL)
