"""Parity of the torch port's O(3) ops with the JAX package and the goldens.

Inputs are numpy arrays from a seed, fed to both packages. Plans must agree
entry for entry; contractions within rtol=atol=1e-5 (float32, another
summation order).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matten_tpu.ops import cartesian as jcart
from matten_tpu.ops import scatter as jscatter
from matten_tpu.ops import spherical_harmonics as jsh
from matten_tpu.ops import tensor_product as jtp
from matten_tpu.ops.irreps import Irreps
from matten_tpu_torch.ops import cartesian as tcart
from matten_tpu_torch.ops import scatter as tscatter
from matten_tpu_torch.ops import spherical_harmonics as tsh
from matten_tpu_torch.ops import tensor_product as ttp

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN = Path(__file__).resolve().parent / "goldens" / "conventions.npz"

FEATS = Irreps("4x0o+4x0e+2x1o+2x1e+1x2o+1x2e")
SH = Irreps("0e+1o+2e")
PLANS = {
    "uvu": lambda m: m.uvu_tp_plan(FEATS, SH, FEATS),
    "fctp_species": lambda m: m.fully_connected_tp_plan(FEATS, Irreps("5x0e"), FEATS),
    "fctp_sh": lambda m: m.fully_connected_tp_plan(Irreps("3x0e+2x1o"), SH, Irreps("2x0e+2x1o+1x2e")),
}


@pytest.fixture(scope="module")
def gold():
    with np.load(GOLDEN) as f:
        return dict(f)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_plan_matches_jax_plan(kind):
    pj, pt = PLANS[kind](jtp), PLANS[kind](ttp)
    assert tuple(pt.irreps_out) == tuple(pj.irreps_out)
    assert [tuple(i) for i in pt.instructions] == [tuple(i) for i in pj.instructions]
    assert pt.path_weights == pj.path_weights
    assert pt.weight_shapes == pj.weight_shapes
    assert pt.weight_numel == pj.weight_numel
    assert pt.in2_is_onehot_compatible == pj.in2_is_onehot_compatible


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_apply_matches_jax(kind):
    rng = np.random.default_rng(0)
    pj, pt = PLANS[kind](jtp), PLANS[kind](ttp)
    b = 7
    x1 = rng.normal(size=(b, pj.irreps_in1.dim)).astype(np.float32)
    x2 = rng.normal(size=(b, pj.irreps_in2.dim)).astype(np.float32)
    # per-element weights (radial MLP) and shared weights (FCTP parameters)
    for w in (
        rng.normal(size=(b, pj.weight_numel)).astype(np.float32),
        rng.normal(size=(pj.weight_numel,)).astype(np.float32),
    ):
        ref = np.asarray(pj.apply(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
        out = pt.apply(_t(x1), _t(x2), _t(w)).numpy()
        np.testing.assert_allclose(out, ref, **TOL)


def test_apply_scalar_matmul_matches_jax_and_apply():
    """The JAX conv's species FCTP below 16 species (`apply_scalar_matmul`)
    is the port's `apply` on the one-hot."""
    rng = np.random.default_rng(1)
    pj, pt = PLANS["fctp_species"](jtp), PLANS["fctp_species"](ttp)
    x1 = rng.normal(size=(9, pj.irreps_in1.dim)).astype(np.float32)
    x2 = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 9)]
    x2[-2:] = 0.0  # padded nodes: all-zero one-hot
    w = rng.normal(size=(pj.weight_numel,)).astype(np.float32)
    ref = np.asarray(pj.apply_scalar_matmul(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    out = pt.apply(_t(x1), _t(x2), _t(w)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert not out[-2:].any()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("s", [16, 73])
def test_apply_onehot2_matches_jax_and_apply(s, masked):
    """The species FCTP's gather form (`apply_onehot2`) against the JAX
    function and against the port's `apply` on the one-hot (times the node
    mask, as the conv applies it from 16 species on): values, and the
    gradients of a seeded cotangent with respect to x1 and the weights
    against autograd of `apply`."""
    rng = np.random.default_rng(s + masked)
    pj = jtp.fully_connected_tp_plan(FEATS, Irreps(f"{s}x0e"), FEATS)
    pt = ttp.fully_connected_tp_plan(FEATS, Irreps(f"{s}x0e"), FEATS)
    n = 11
    x1 = rng.normal(size=(n, pj.irreps_in1.dim)).astype(np.float32)
    idx = rng.integers(0, s, n).astype(np.int32)
    mask = np.arange(n) < n - 3 if masked else None  # three padded nodes
    w = rng.normal(size=(pj.weight_numel,)).astype(np.float32)
    g = rng.normal(size=(n, pj.irreps_out.dim)).astype(np.float32)
    ref = np.asarray(pj.apply_onehot2(jnp.asarray(x1), jnp.asarray(idx), jnp.asarray(w),
                                      mask=None if mask is None else jnp.asarray(mask)))

    def grads(fn):
        xt, wt = _t(x1).requires_grad_(), _t(w).requires_grad_()
        out = fn(xt, wt)
        out.backward(_t(g))
        return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()

    tmask = None if mask is None else _t(mask)
    out, dx, dw = grads(lambda x, wt: pt.apply_onehot2(x, _t(idx).long(), wt, mask=tmask))
    onehot = np.eye(s, dtype=np.float32)[idx] * (1.0 if mask is None else mask[:, None])
    keep = 1.0 if mask is None else tmask[:, None].float()
    ref_t, dx_ref, dw_ref = grads(lambda x, wt: pt.apply(x, _t(onehot), wt) * keep)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, ref_t, **TOL)
    np.testing.assert_allclose(dx, dx_ref, **TOL)
    np.testing.assert_allclose(dw, dw_ref, **TOL)
    if masked:
        assert not out[~mask].any() and not dx[~mask].any()


def test_linear_plan_matches_jax():
    rng = np.random.default_rng(2)
    lj = jtp.LinearPlan(Irreps("4x0e+2x1o+2x2e+4e"), Irreps("2x0e+2x2e+4e"))
    lt = ttp.LinearPlan(Irreps("4x0e+2x1o+2x2e+4e"), Irreps("2x0e+2x2e+4e"))
    assert lt.connections == lj.connections and lt.weight_numel == lj.weight_numel
    x = rng.normal(size=(5, lj.irreps_in.dim)).astype(np.float32)
    w = rng.normal(size=(lj.weight_numel,)).astype(np.float32)
    ref = np.asarray(lj.apply(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(lt.apply(_t(x), _t(w)).numpy(), ref, **TOL)


def test_spherical_harmonics_match_jax_and_golden(gold):
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(50, 3)).astype(np.float32)
    vecs[0] = 0.0  # padding edge: zero vector
    irreps = Irreps("0e+1o+2e+3o+4e")
    ref = np.asarray(jsh.spherical_harmonics(irreps, jnp.asarray(vecs)))
    np.testing.assert_allclose(tsh.spherical_harmonics(irreps, _t(vecs)).numpy(), ref, **TOL)
    out = tsh.spherical_harmonics(irreps, _t(gold["sh_vecs"])).numpy()
    np.testing.assert_allclose(out, gold["sh_lmax4"], atol=1e-5)


def test_uvu_plan_golden(gold):
    plan = ttp.uvu_tp_plan(
        Irreps("4x0e+4x0o+2x1o+2x1e+1x2e"), Irreps("0e+1o+2e"),
        Irreps("4x0e+4x0o+2x1o+2x1e+1x2e"),
    )
    np.testing.assert_allclose(np.asarray(plan.path_weights), gold["uvu_path_weights"], atol=1e-9)
    out = plan.apply(_t(gold["uvu_x1"]), _t(gold["uvu_x2"]), _t(gold["uvu_w"])).numpy()
    np.testing.assert_allclose(out, gold["uvu_out"], atol=1e-5)


@pytest.mark.parametrize("formula,key", [("ijkl=jikl=klij", "cart_elastic"), ("ij=ji", "cart_nmr")])
def test_cartesian_basis_matches_golden_and_jax(gold, formula, key):
    mt = tcart.cartesian_tensor_map(formula)
    mj = jcart.cartesian_tensor_map(formula)
    np.testing.assert_allclose(mt.basis, gold[key], atol=1e-9)
    assert tuple(mt.irreps) == tuple(mj.irreps)
    x = np.random.default_rng(4).normal(size=(3, mt.irreps.dim)).astype(np.float32)
    ref = np.asarray(mj.to_cartesian(jnp.asarray(x)))
    np.testing.assert_allclose(mt.to_cartesian(_t(x)).numpy(), ref, **TOL)


def test_scatter_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.normal(size=(40, 6)).astype(np.float32)
    idx = np.sort(rng.integers(0, 9, 40)).astype(np.int32)
    w = (rng.uniform(size=40) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tscatter.scatter_sum(_t(src), _t(idx), 11).numpy(),
        np.asarray(jscatter.scatter_sum(jnp.asarray(src), jnp.asarray(idx), 11)),
        **TOL,
    )
    np.testing.assert_allclose(
        tscatter.scatter_mean(_t(src), _t(idx), 11, weights=_t(w)).numpy(),
        np.asarray(jscatter.scatter_mean(jnp.asarray(src), jnp.asarray(idx), 11, weights=jnp.asarray(w))),
        **TOL,
    )
