"""bf16 storage of the conv's edge inputs and the kernel-tier switch
(`kernels/fused_tp.py`) against the JAX package.

With `set_kernel_in_dtype("bfloat16")` in both packages, the port's plain
versions (what the CPU runs and what the CUDA kernels are held to) read sh
and w rounded to bfloat16, as the JAX v2 kernels (`fused_uvu_conv_t`,
Pallas interpret mode) do. Both sides then compute in float32 on the same
rounded inputs, so the tolerance is the float32 one, max|d| <= 1e-5
max|ref| (another summation order), not the JAX test's 3e-2 of bf16 noise.
Each test resets both packages' settings in `finally`.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matten_tpu.data import keys as JK
from matten_tpu.kernels import fused_tp as jfused_tp
from matten_tpu.kernels.fused_conv import _reference, fused_uvu_conv_t
from matten_tpu.nn.common import freeze_irreps
from matten_tpu.nn.conv import PointConv as JaxPointConv
from matten_tpu.ops import tensor_product as jtp
from matten_tpu.ops.irreps import Irreps
from matten_tpu_torch.convert import flax_to_state_dict
from matten_tpu_torch.kernels import fused_conv, fused_tp
from matten_tpu_torch.nn.conv import PointConv
from matten_tpu_torch.ops import tensor_product as ttp

torch.set_num_threads(2)

IR1, IR2 = Irreps("8x0e+4x1o+2x2e"), Irreps("0e+1o+2e")


@contextlib.contextmanager
def bf16_storage(jax_pallas=False):
    """Both packages at bf16 storage (and the JAX PointConv on its Pallas
    tier in interpret mode), reset to their defaults on the way out."""
    jfused_tp.set_kernel_in_dtype("bfloat16")
    fused_tp.set_kernel_in_dtype("bfloat16")
    if jax_pallas:
        jfused_tp.set_tp_impl("pallas", interpret=True)
    try:
        yield
    finally:
        jfused_tp.set_kernel_in_dtype("float32")
        fused_tp.set_kernel_in_dtype("float32")
        jfused_tp.set_tp_impl("xla", interpret=False)


def _assert_rel(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


def _rounded(a):
    return torch.as_tensor(a).to(torch.bfloat16).float().numpy()


def _setup(seed, n_in, n_out, e=96):
    rng = np.random.default_rng(seed)
    pj, pt = jtp.uvu_tp_plan(IR1, IR2, IR1), ttp.uvu_tp_plan(IR1, IR2, IR1)
    a = dict(
        x=rng.normal(size=(n_in, IR1.dim)).astype(np.float32),
        sh=rng.normal(size=(e, IR2.dim)).astype(np.float32),
        w=rng.normal(size=(e, pj.weight_numel)).astype(np.float32),
        src=rng.integers(0, n_in, e).astype(np.int32),
        dst=np.sort(rng.integers(0, n_out, e)).astype(np.int32),
    )
    g = rng.normal(size=(n_out, pj.irreps_out.dim)).astype(np.float32)
    return pj, pt, a, g


@pytest.mark.parametrize("n_in,n_out", [(24, 24), (32, 16)])
def test_plain_forward_and_gradients_match_jax_bf16_kernels(n_in, n_out):
    """out, dx, dsh and dw of the port's conv on CPU tensors at bf16 storage
    == the JAX v2 kernels' (interpret mode) at bf16 storage; dw is float32,
    the float32 gradient at the rounded inputs; the public `uvu_conv_bwd`
    gives the same dx and dw."""
    pj, pt, a, g = _setup(51, n_in, n_out)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    x, sh, w = (t[k].clone().requires_grad_() for k in ("x", "sh", "w"))
    with bf16_storage():
        out_j, vjp = jax.vjp(
            lambda x_, sh_, wT_: fused_uvu_conv_t(pj, x_, sh_, wT_, j["src"], j["dst"],
                                                  num_nodes_out=n_out, block=16, interpret=True),
            j["x"], j["sh"], j["w"].T)
        dx_j, dsh_j, dwT_j = vjp(jnp.asarray(g))
        out = fused_conv.fused_uvu_conv(pt, x, sh, w, t["src"], t["dst"], n_out)
        out.backward(torch.as_tensor(g))
        dx2, dw2 = fused_conv.uvu_conv_bwd(pt, t["x"], torch.as_tensor(g), t["sh"], t["w"],
                                           t["src"], t["dst"], n_in)
    assert w.grad.dtype == torch.float32 and dw2.dtype == torch.float32
    _assert_rel(out.detach(), out_j)
    _assert_rel(x.grad, dx_j)
    _assert_rel(sh.grad, dsh_j)
    _assert_rel(w.grad, np.asarray(dwT_j).T)
    _assert_rel(dx2, dx_j)
    _assert_rel(dw2, np.asarray(dwT_j).T)
    # dw: JAX's float32 reference gradient at the rounded sh and w, unrounded
    _, vjp_ref = jax.vjp(lambda w_: _reference(pj, j["x"], jnp.asarray(_rounded(a["sh"])), w_,
                                               j["src"], j["dst"], n_out),
                         jnp.asarray(_rounded(a["w"])))
    _assert_rel(w.grad, vjp_ref(jnp.asarray(g))[0])
    # the rounding is real: float32 storage gives another output
    ref32 = fused_conv.uvu_conv_reference(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], n_out)
    assert not torch.equal(out.detach(), ref32)


def test_plain_versions_round_sh_and_w_only():
    """uvu_conv_reference at bf16 == the float32 version on rounded sh and w
    (x and the cotangent unrounded), and no kernel is counted on the CPU."""
    _, pt, a, g = _setup(52, 24, 24)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    r = {k: torch.as_tensor(_rounded(a[k])) for k in ("sh", "w")}
    before = (fused_conv.bf16_launches, fused_conv.bf16_bwd_launches)
    with bf16_storage():
        out = fused_conv.uvu_conv_reference(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], 24)
        dx, dw = fused_conv.uvu_conv_bwd_reference(pt, t["x"], torch.as_tensor(g), t["sh"], t["w"],
                                                   t["src"], t["dst"], 24)
    assert torch.equal(out, fused_conv.uvu_conv_reference(pt, t["x"], r["sh"], r["w"], t["src"],
                                                          t["dst"], 24))
    dx32, dw32 = fused_conv.uvu_conv_bwd_reference(pt, t["x"], torch.as_tensor(g), r["sh"], r["w"],
                                                   t["src"], t["dst"], 24)
    assert torch.equal(dx, dx32) and torch.equal(dw, dw32)
    assert (fused_conv.bf16_launches, fused_conv.bf16_bwd_launches) == before


def test_launch_takes_sh_and_w_in_one_storage_dtype():
    """The launches take sh and w both float32 or both bf16; a mix, or
    another dtype, is refused before anything is built."""
    _, pt, a, _ = _setup(53, 24, 24)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    edges = fused_conv.edge_plan(t["src"], t["dst"], 24, 24)
    with pytest.raises(TypeError, match="w is torch.float32"):
        fused_conv._launch(pt, t["x"], t["sh"].bfloat16(), t["w"], edges)
    with pytest.raises(TypeError, match="sh is torch.float16"):
        fused_conv._launch(pt, t["x"], t["sh"].half(), t["w"].half(), edges)
    g = torch.zeros(24, pt.irreps_out.dim)
    with pytest.raises(TypeError, match="w is torch.bfloat16"):
        fused_conv._launch_bwd(pt, t["x"], g, t["sh"], t["w"].bfloat16(), edges)


@pytest.mark.parametrize("avg", [30.0, None])
def test_point_conv_at_bf16_matches_jax(avg):
    """A PointConv layer at bf16 storage: the port on the CPU against the
    JAX layer on its Pallas tier (interpret mode) at bf16 storage, with the
    same (converted) weights; and its input gradient."""
    rng = np.random.default_rng(54)
    n, e, s = 12, 60, 5
    feats, shi = Irreps("6x0e+2x1o"), Irreps("0e+1o+2e")
    mask = np.arange(n) < n - 2
    data = {
        JK.NODE_FEATURES: rng.normal(size=(n, feats.dim)).astype(np.float32),
        JK.NODE_ATTRS: np.eye(s, dtype=np.float32)[rng.integers(0, s, n)] * mask[:, None],
        JK.EDGE_ATTRS: rng.normal(size=(e, shi.dim)).astype(np.float32),
        JK.EDGE_EMBEDDING: rng.normal(size=(e, 8)).astype(np.float32),
        JK.EDGE_INDEX: np.stack([rng.integers(0, n - 2, e),
                                 np.sort(rng.integers(0, n - 2, e))]).astype(np.int32),
        JK.NUM_NEIGH: rng.integers(1, 8, n).astype(np.float32),
        JK.NODE_MASK: mask,
    }
    irreps = {JK.NODE_FEATURES: feats, JK.NODE_ATTRS: Irreps(f"{s}x0e"),
              JK.EDGE_ATTRS: shi, JK.EDGE_EMBEDDING: Irreps("8x0e")}
    conv_irreps = Irreps("4x0o+4x0e+2x1o+2x1e+1x2o+1x2e")
    kw = dict(fc_num_hidden_layers=2, fc_hidden_size=8, avg_num_neighbors=avg)
    jm = JaxPointConv(irreps_in=freeze_irreps(irreps), conv_layer_irreps=conv_irreps, **kw)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd))
    variables = jax.tree_util.tree_map(
        lambda sd: rng.normal(size=sd.shape).astype(np.float32), shapes)
    tm = PointConv(irreps, conv_irreps, torch.Generator(), **kw)
    tm.load_state_dict(flax_to_state_dict(variables, tm))
    cot = rng.normal(size=(n, tm.irreps_out[JK.NODE_FEATURES].dim)).astype(np.float32)
    with bf16_storage(jax_pallas=True):
        def f(x_):
            return jm.apply(variables, {**jd, JK.NODE_FEATURES: x_})[JK.NODE_FEATURES]

        ref, vjp = jax.vjp(f, jd[JK.NODE_FEATURES])
        (dref,) = vjp(jnp.asarray(cot))
        td = {k: torch.as_tensor(v) for k, v in data.items()}
        x = td[JK.NODE_FEATURES].clone().requires_grad_()
        out = tm({**td, JK.NODE_FEATURES: x})[JK.NODE_FEATURES]
        out.backward(torch.as_tensor(cot))
    _assert_rel(out.detach(), ref)
    _assert_rel(x.grad, dref)
    # the JAX layer at float32 storage on its XLA tier gives another output
    assert not np.array_equal(np.asarray(ref), np.asarray(f(jd[JK.NODE_FEATURES])))


def test_tier_switch_and_its_environment(monkeypatch, caplog):
    """`configure_default_tiers` reads MATTEN_TP_IMPL (default: the kernels)
    and logs an explicit xla; `force_plain` sets the same flag for a block;
    unknown names are refused."""
    assert fused_tp.get_tp_impl() == "pallas" and fused_tp.get_kernel_in_dtype() == "float32"
    try:
        monkeypatch.delenv("MATTEN_TP_IMPL", raising=False)
        monkeypatch.setenv("MATTEN_AGG_DTYPE", "bfloat16")  # not read by the port
        assert fused_tp.configure_default_tiers() == "pallas"
        assert fused_tp.get_tp_impl() == "pallas" and fused_tp.get_kernel_in_dtype() == "float32"
        monkeypatch.setenv("MATTEN_TP_IMPL", "xla")
        with caplog.at_level("INFO", logger="matten_tpu_torch.kernels.fused_tp"):
            assert fused_tp.configure_default_tiers() == "xla"
        assert fused_tp.get_tp_impl() == "xla"
        assert any("MATTEN_TP_IMPL=xla" in r.message for r in caplog.records)
        fused_tp.set_tp_impl("pallas")
        with fused_conv.force_plain():
            assert fused_tp.get_tp_impl() == "xla"
        assert fused_tp.get_tp_impl() == "pallas"
        monkeypatch.setenv("MATTEN_TP_IMPL", "mosaic")
        with pytest.raises(ValueError, match="mosaic"):
            fused_tp.configure_default_tiers()
        with pytest.raises(ValueError, match="float16"):
            fused_tp.set_kernel_in_dtype("float16")
    finally:
        fused_tp.set_tp_impl("pallas")
