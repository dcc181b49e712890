"""The port's fused uvu conv (K1): plain version, tables, wrapper contract.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
checked against it by tests/test_torch_gpu.py (skipped without a card) and
by chip_smoke.py. The kernel's per-plan tables are checked here by emulating
the kernel's arithmetic from them in torch. Tolerances: rtol=atol=1e-5
(float32, another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matten_tpu.kernels.fused_conv import _reference, fused_uvu_conv_t
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


def test_backward_raises_naming_k2():
    with pytest.raises(NotImplementedError, match="K2"):
        fused_conv._FusedUvuConv.backward(None, torch.zeros(1))
