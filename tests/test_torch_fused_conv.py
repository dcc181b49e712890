"""The port's fused uvu conv: K1 forward and the dx / dw backward kernels'
plain versions, tables and wrapper contracts.

On the CPU the wrappers run the plain versions; the CUDA kernels themselves
are checked against them by tests/test_torch_gpu.py (skipped without a card)
and by chip_smoke.py. The kernels' per-plan tables are checked here by
emulating the kernels' arithmetic from them in torch. Tolerances: forward
rtol=atol=1e-5 (float32, another summation order); gradients atol=1e-4
after scaling by max(|ref|, 1), as the JAX package's own gradient tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matten_tpu.kernels.fused_conv import _reference, fused_uvu_conv, fused_uvu_conv_t
from matten_tpu.ops import tensor_product as jtp
from matten_tpu.ops.irreps import Irreps
from matten_tpu_torch.kernels import fused_conv
from matten_tpu_torch.ops import tensor_product as ttp

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
IR1, IR2 = Irreps("8x0e+4x1o+2x2e"), Irreps("0e+1o+2e")


def _setup(seed, n_in=24, n_out=24, e=96, ir1=IR1, ir2=IR2, out=None):
    rng = np.random.default_rng(seed)
    out = IR1 if out is None else out
    pj, pt = jtp.uvu_tp_plan(ir1, ir2, out), ttp.uvu_tp_plan(ir1, ir2, out)
    arrs = dict(
        x=rng.normal(size=(n_in, ir1.dim)).astype(np.float32),
        sh=rng.normal(size=(e, ir2.dim)).astype(np.float32),
        w=rng.normal(size=(e, pj.weight_numel)).astype(np.float32),
        src=rng.integers(0, n_in, e).astype(np.int32),
        dst=np.sort(rng.integers(0, n_out, e)).astype(np.int32),
    )
    return pj, pt, arrs, n_out


def _torch(arrs, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in arrs.items()}


@pytest.mark.parametrize("n_in,n_out", [(24, 24), (32, 16)])
def test_reference_matches_jax_fused_kernel_and_reference(n_in, n_out):
    """Plain version == JAX K1 (Pallas interpret mode, block 16) == JAX
    `_reference`, including a halo-style n_in != n_out."""
    pj, pt, a, n = _setup(21, n_in=n_in, n_out=n_out)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    ref_kernel = np.asarray(
        fused_uvu_conv_t(pj, j["x"], j["sh"], j["w"].T, j["src"], j["dst"],
                         num_nodes_out=n, block=16, interpret=True)
    )
    ref_plain = np.asarray(_reference(pj, j["x"], j["sh"], j["w"], j["src"], j["dst"], n))
    t = _torch(a)
    out = fused_conv.uvu_conv_reference(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], n).numpy()
    np.testing.assert_allclose(out, ref_kernel, **TOL)
    np.testing.assert_allclose(out, ref_plain, **TOL)


def test_wrapper_on_cpu_runs_the_plain_version():
    _, pt, a, n = _setup(22)
    t = _torch(a)
    before = fused_conv.launches
    out = fused_conv.fused_uvu_conv(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
    ref = fused_conv.uvu_conv_reference(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
    assert fused_conv.launches == before
    assert torch.equal(out, ref)


def _emulate_kernel(plan, x, sh, w, src, dst, n_out):
    """The kernel's arithmetic, read off its tables: t = CG blocks . sh,
    msg[e, o] = w[e, w_idx] * sum_m1 t[e, t_idx + m1 d3] x[src, x_idx + m1],
    out = pw * segment sum."""
    t_meta, cg, out_meta, out_pw = (torch.as_tensor(a) for a in fused_conv.kernel_tables(plan))
    g = torch.zeros(sh.shape[1], t_meta.shape[0])
    for i, (cg_off, sh_off, d2, _) in enumerate(t_meta.tolist()):
        g[sh_off : sh_off + d2, i] = cg[cg_off : cg_off + d2]
    t = sh @ g
    x_idx, t_idx, w_idx = out_meta[:, 0].long(), out_meta[:, 1].long(), out_meta[:, 2].long()
    d1, d3 = (out_meta[:, 3] & 0xFFFF).long(), (out_meta[:, 3] >> 16).long()
    xg = x[src.long()]
    s = torch.zeros(sh.shape[0], out_meta.shape[0])
    for m1 in range(int(d1.max())):
        on = m1 < d1
        ti = torch.where(on, t_idx + m1 * d3, 0)
        xi = torch.where(on, x_idx + m1, 0)
        s = s + on * t[:, ti] * xg[:, xi]
    msg = w[:, w_idx] * s * out_pw
    return torch.zeros(n_out, msg.shape[1]).index_add_(0, dst.long(), msg)


@pytest.mark.parametrize(
    "ir1,ir2,out",
    [
        (IR1, IR2, IR1),
        # both parities of every l, as in the production layers: paths of
        # opposite parity share CG blocks (the production plans themselves,
        # SH lmax 4, run in chip_smoke.py on the card)
        (
            Irreps("4x0e+4x0o+2x1o+2x1e+1x2e+1x2o"),
            Irreps("0e+1o+2e"),
            Irreps("4x0o+4x0e+2x1o+2x1e+1x2o+1x2e"),
        ),
    ],
)
def test_kernel_tables_reproduce_the_plain_version(ir1, ir2, out):
    _, pt, a, n = _setup(23, n_in=6, n_out=5, e=12, ir1=ir1, ir2=ir2, out=out)
    t = _torch(a)
    emu = _emulate_kernel(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
    ref = fused_conv.uvu_conv_reference(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), **TOL)


def test_launch_rejects_bad_inputs():
    _, pt, a, n = _setup(24)
    t = _torch(a)
    args = [t["x"], t["sh"], t["w"], t["src"], t["dst"]]
    bad_dtype = [t["x"].double()] + args[1:]
    with pytest.raises(TypeError):
        fused_conv._launch(pt, *bad_dtype, n)
    bad_layout = args[:2] + [t["w"].t().contiguous().t()] + args[3:]
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv._launch(pt, *bad_layout, n)
    unsorted = args[:4] + [t["dst"].flip(0).contiguous()]
    with pytest.raises(ValueError, match="non-decreasing"):
        fused_conv._launch(pt, *unsorted, n)
    with pytest.raises(ValueError, match="shape"):
        fused_conv._launch(pt, args[0][:, :-1].contiguous(), *args[1:], n)


# ---------------------------------------------------------------- backward


def _assert_grads_close(got, ref):
    for a, b in zip(got, ref):
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale, atol=1e-4)


def _port_grads(pt, a, n):
    """(dx, dsh, dw) of sum(out^2) through the port's wrapper on the CPU
    (autograd of the plain version), and dx, dw again from the plain
    backward versions at the same cotangent."""
    t = _torch(a)
    x, sh, w = (t[k].clone().requires_grad_() for k in ("x", "sh", "w"))
    out = fused_conv.fused_uvu_conv(pt, x, sh, w, t["src"], t["dst"], n)
    (out ** 2).sum().backward()
    g = 2 * out.detach()
    dx = fused_conv.uvu_conv_dx(pt, g, t["sh"], t["w"], t["src"], t["dst"], x.shape[0])
    dw = fused_conv.uvu_conv_dw(pt, t["x"], g, t["sh"], t["src"], t["dst"])
    return (x.grad.numpy(), sh.grad.numpy(), w.grad.numpy()), (dx.numpy(), dw.numpy())


@pytest.mark.parametrize("n_in,n_out", [(24, 24), (32, 16)])
def test_gradient_matches_jax_merged_backward(n_in, n_out):
    """dx, dsh, dw == jax.grad through `fused_uvu_conv_t` (interpret mode,
    block 16), whose backward is the merged kernel K2 `_build_bwd2`."""
    pj, pt, a, n = _setup(31, n_in=n_in, n_out=n_out)
    j = {k: jnp.asarray(v) for k, v in a.items()}

    def loss(x, sh, wT):
        out = fused_uvu_conv_t(pj, x, sh, wT, j["src"], j["dst"],
                               num_nodes_out=n, block=16, interpret=True)
        return (out ** 2).sum()

    gx, gsh, gwT = jax.grad(loss, argnums=(0, 1, 2))(j["x"], j["sh"], j["w"].T)
    ref = (np.asarray(gx), np.asarray(gsh), np.asarray(gwT).T)
    (dx, dsh, dw), (dx_plain, dw_plain) = _port_grads(pt, a, n)
    _assert_grads_close((dx, dsh, dw), ref)
    _assert_grads_close((dx_plain, dw_plain), (ref[0], ref[2]))


def test_gradient_matches_jax_chunked_backward():
    """dx, dsh, dw == jax.grad through the node-chunked `fused_uvu_conv`
    (interpret mode), whose backward is the transposed v1 kernel K3
    (`_build_call(transpose=True)` over src_perm) for dx and K4
    (`_build_dw_call`) for dw: the path JAX takes beyond 2048 nodes. The
    chunk-aligned layout interleaves inert fill edges, so the port gets the
    same edges stably sorted by destination."""
    from matten_tpu.data import keys as JK
    from matten_tpu.data.graph import chunk_align_edges
    from matten_tpu.kernels.fused_conv import EdgeChunks

    rng = np.random.default_rng(32)
    n, e_real, node_chunk, block = 24, 60, 8, 16
    pj, pt, _, _ = _setup(32)
    capacity = (int(np.ceil(e_real / block)) + n // node_chunk + 1) * block
    src = rng.integers(0, n, capacity).astype(np.int32)
    dst = np.sort(rng.integers(0, n, capacity)).astype(np.int32)
    mask = np.zeros(capacity, dtype=bool)
    mask[:e_real] = True
    f = chunk_align_edges(np.stack([src, dst]), np.zeros((capacity, 3), np.float32),
                          mask, n, node_chunk, block, capacity)
    chunks = EdgeChunks(*(jnp.asarray(f[k]) for k in
                          (JK.EDGE_DST_CHUNK, JK.EDGE_SRC_PERM, JK.EDGE_SRC_CHUNK)))
    em = f[JK.EDGE_MASK][:, None]
    e = em.shape[0]
    a = dict(
        x=rng.normal(size=(n, IR1.dim)).astype(np.float32),
        sh=(rng.normal(size=(e, IR2.dim)) * em).astype(np.float32),
        w=(rng.normal(size=(e, pj.weight_numel)) * em).astype(np.float32),
        src=f[JK.EDGE_INDEX][0].astype(np.int32),
        dst=f[JK.EDGE_INDEX][1].astype(np.int32),
    )
    j = {k: jnp.asarray(v) for k, v in a.items()}

    def loss(x, sh, w):
        out = fused_uvu_conv(pj, x, sh, w, j["src"], j["dst"], chunks=chunks,
                             block=block, node_chunk=node_chunk, interpret=True)
        return (out ** 2).sum()

    gx, gsh, gw = (np.asarray(v) for v in jax.grad(loss, argnums=(0, 1, 2))(j["x"], j["sh"], j["w"]))
    order = np.argsort(a["dst"], kind="stable")
    sorted_a = {k: (v if k == "x" else v[order]) for k, v in a.items()}
    (dx, dsh, dw), (dx_plain, dw_plain) = _port_grads(pt, sorted_a, n)
    _assert_grads_close((dx, dsh, dw), (gx, gsh[order], gw[order]))
    _assert_grads_close((dx_plain, dw_plain), (gx, gw[order]))


def _emulate_backward(plan, x, g, sh, w, src, dst):
    """The dx and dw kernels' arithmetic, read off their tables:
    gw[e, o] = pw g[dst, o] w[e, w_idx(o)];
    dx[src, c] += sum_{entries of c} sum_m3 gw[e, o_base + m3] t[e, t_base + m3];
    dw[e, k] = sum_m3 pw g[dst, o_base + m3] sum_m1 t[e, t_off + m1 d3 + m3] x[src, x_base + m1]."""
    t_meta, cg, out_meta, out_pw = (torch.as_tensor(v) for v in fused_conv.kernel_tables(plan))
    dx_ptr, dx_meta, dw_meta = fused_conv.backward_tables(plan)
    G = torch.zeros(sh.shape[1], t_meta.shape[0])
    for i, (cg_off, sh_off, d2, _) in enumerate(t_meta.tolist()):
        G[sh_off : sh_off + d2, i] = cg[cg_off : cg_off + d2]
    t = sh @ G
    gd = g[dst.long()] * out_pw
    gw = gd * w[:, out_meta[:, 2].long()]
    xg = x[src.long()]
    dxe = torch.zeros(sh.shape[0], x.shape[1])
    for c in range(x.shape[1]):
        for o_base, t_base, d3, _ in dx_meta[dx_ptr[c] : dx_ptr[c + 1]]:
            dxe[:, c] += (gw[:, o_base : o_base + d3] * t[:, t_base : t_base + d3]).sum(1)
    dx = torch.zeros_like(x).index_add_(0, src.long(), dxe)
    dw = torch.zeros_like(w)
    for k, (x_base, t_off, o_base, dims) in enumerate(dw_meta):
        d1, d3 = dims & 0xFFFF, dims >> 16
        for m3 in range(d3):
            a = sum(t[:, t_off + m1 * d3 + m3] * xg[:, x_base + m1] for m1 in range(d1))
            dw[:, k] += gd[:, o_base + m3] * a
    return dx, dw


@pytest.mark.parametrize(
    "ir1,ir2,out",
    [
        (IR1, IR2, IR1),
        (
            Irreps("4x0e+4x0o+2x1o+2x1e+1x2e+1x2o"),
            Irreps("0e+1o+2e"),
            Irreps("4x0o+4x0e+2x1o+2x1e+1x2o+1x2e"),
        ),
    ],
)
def test_backward_tables_reproduce_the_plain_versions(ir1, ir2, out):
    _, pt, a, n = _setup(33, n_in=7, n_out=5, e=12, ir1=ir1, ir2=ir2, out=out)
    t = _torch(a)
    g = torch.as_tensor(np.random.default_rng(34).normal(size=(n, pt.irreps_out.dim)).astype(np.float32))
    dx, dw = _emulate_backward(pt, t["x"], g, t["sh"], t["w"], t["src"], t["dst"])
    dx_ref = fused_conv.uvu_conv_dx_reference(pt, g, t["sh"], t["w"], t["src"], t["dst"], 7)
    dw_ref = fused_conv.uvu_conv_dw_reference(pt, t["x"], g, t["sh"], t["src"], t["dst"])
    np.testing.assert_allclose(dx.numpy(), dx_ref.numpy(), **TOL)
    np.testing.assert_allclose(dw.numpy(), dw_ref.numpy(), **TOL)
    # every input component that some path reads has entries; each weight one row
    assert len(fused_conv.backward_tables(pt).dw_meta) == pt.weight_numel


def test_backward_wrappers_on_cpu_run_the_plain_versions():
    _, pt, a, n = _setup(35)
    t = _torch(a)
    g = torch.ones(n, pt.irreps_out.dim)
    before = (fused_conv.dx_launches, fused_conv.dw_launches)
    dx = fused_conv.uvu_conv_dx(pt, g, t["sh"], t["w"], t["src"], t["dst"], 24)
    dw = fused_conv.uvu_conv_dw(pt, t["x"], g, t["sh"], t["src"], t["dst"])
    assert (fused_conv.dx_launches, fused_conv.dw_launches) == before
    assert torch.equal(dx, fused_conv.uvu_conv_dx_reference(pt, g, t["sh"], t["w"], t["src"], t["dst"], 24))
    assert torch.equal(dw, fused_conv.uvu_conv_dw_reference(pt, t["x"], g, t["sh"], t["src"], t["dst"]))


def test_backward_launches_reject_bad_inputs():
    _, pt, a, n = _setup(36)
    t = _torch(a)
    g = torch.ones(n, pt.irreps_out.dim)
    with pytest.raises(TypeError):
        fused_conv._launch_dx(pt, g.double(), t["sh"], t["w"], t["src"], t["dst"], 24)
    with pytest.raises(ValueError, match="shape"):
        fused_conv._launch_dx(pt, g[:, :-1].contiguous(), t["sh"], t["w"], t["src"], t["dst"], 24)
    with pytest.raises(ValueError, match="non-decreasing"):
        fused_conv._launch_dx(pt, g, t["sh"], t["w"], t["src"], t["dst"].flip(0).contiguous(), 24)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv._launch_dw(pt, t["x"], g.t().contiguous().t(), t["sh"], t["src"], t["dst"])
    with pytest.raises(ValueError, match="non-decreasing"):
        fused_conv._launch_dw(pt, t["x"], g, t["sh"], t["src"], t["dst"].flip(0).contiguous())
