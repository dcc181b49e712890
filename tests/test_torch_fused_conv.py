"""The port's fused uvu conv: K1 forward and the merged backward's plain
versions, tables and wrapper contracts.

On the CPU the wrappers run the plain versions; the CUDA kernels themselves
are checked against them by tests/test_torch_gpu.py (skipped without a card)
and by chip_smoke.py. The kernels' per-plan tables are checked here by
replaying the kernels' arithmetic from them. Tolerances: forward and
replays rtol=atol=1e-5 (float32 data, another summation order); gradients
atol=1e-4 after scaling by max(|ref|, 1), as the JAX package's own gradient
tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from matten_tpu.kernels.fused_conv import _reference, fused_uvu_conv, fused_uvu_conv_t
from matten_tpu.ops import tensor_product as jtp
from matten_tpu.ops.irreps import Irreps
from matten_tpu_torch.kernels import fused_conv
from matten_tpu_torch.ops import tensor_product as ttp

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

TOL = dict(rtol=1e-5, atol=1e-5)
IR1, IR2 = Irreps("8x0e+4x1o+2x2e"), Irreps("0e+1o+2e")
# a plan above l=4, which the kernels' generic paths take: d1 and d3 up to
# 11, an sh irrep of 11 components
L5_IR1, L5_IR2 = Irreps("2x0e+1x1o+1x5o+1x5e"), Irreps("0e+1o+2e+3o+4e+5o")
# the edges per K1 item and per backward tile of the kernels' tiers
TIER_EDGES = (16, 8, 4)


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


@pytest.mark.parametrize("n_in,n_out,ir1,ir2", [(24, 24, IR1, IR2), (32, 16, IR1, IR2),
                                               (24, 24, L5_IR1, L5_IR2)], ids=["24", "halo", "l5"])
def test_reference_matches_jax_fused_kernel_and_reference(n_in, n_out, ir1, ir2):
    """Plain version == JAX K1 (Pallas interpret mode, block 16) == JAX
    `_reference`, including a halo-style n_in != n_out and a plan above
    l=4."""
    pj, pt, a, n = _setup(21, n_in=n_in, n_out=n_out, ir1=ir1, ir2=ir2, out=ir1)
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
        (L5_IR1, L5_IR2, L5_IR1),
    ],
)
def test_kernel_tables_reproduce_the_plain_version(ir1, ir2, out):
    _, pt, a, n = _setup(23, n_in=6, n_out=5, e=12, ir1=ir1, ir2=ir2, out=out)
    t = _torch(a)
    emu = _emulate_kernel(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
    ref = fused_conv.uvu_conv_reference(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), **TOL)


def test_launch_rejects_bad_inputs():
    """K1's launch takes the edges as an edge plan, whose build checks the
    indices, and checks x, sh and w against it; a call's plan must be for
    its node and edge counts."""
    _, pt, a, n = _setup(24)
    t = _torch(a)
    edges = fused_conv.edge_plan(t["src"], t["dst"], 24, n)
    args = [t["x"], t["sh"], t["w"]]
    with pytest.raises(TypeError):
        fused_conv._launch(pt, t["x"].double(), *args[1:], edges)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv._launch(pt, *args[:2], t["w"].t().contiguous().t(), edges)
    with pytest.raises(ValueError, match="non-decreasing"):
        fused_conv.edge_plan(t["src"], t["dst"].flip(0).contiguous(), 24, n)
    with pytest.raises(ValueError, match="src in"):
        fused_conv.edge_plan((t["src"] + 24).contiguous(), t["dst"], 24, n)
    with pytest.raises(ValueError, match="shape"):
        fused_conv._launch(pt, args[0][:, :-1].contiguous(), *args[1:], edges)
    with pytest.raises(ValueError, match="shape"):
        fused_conv._launch(pt, *args[:2], t["w"][:-1].contiguous(), edges)
    other = fused_conv.edge_plan(t["src"], t["dst"], 24, n + 1)
    with pytest.raises(ValueError, match="edge plan"):
        fused_conv._plan_for("fused_uvu_conv", t["src"], t["dst"], 24, n, other)
    with pytest.raises(ValueError, match="edge plan"):
        fused_conv._plan_for("uvu_conv_bwd", t["src"][:-1], t["dst"][:-1], 24, n, edges)
    assert fused_conv._plan_for("fused_uvu_conv", t["src"], t["dst"], 24, n, edges) is edges


def test_edge_plan_rejects_bad_edges():
    src = torch.as_tensor(np.array([0, 3, 1, 2], np.int32))
    dst = torch.as_tensor(np.array([0, 0, 2, 3], np.int32))
    plan = fused_conv.edge_plan(src, dst, 4, 4)
    assert plan.n_items == 3 and plan.order is None
    for s, d, n_in, n_out in ((src, dst.flip(0).contiguous(), 4, 4), (src, dst, 3, 4),
                              (src, dst, 4, 3), (src - 1, dst, 4, 4)):
        with pytest.raises(ValueError, match="non-decreasing"):
            fused_conv.edge_plan(s, d, n_in, n_out)
    with pytest.raises(TypeError):
        fused_conv.edge_plan(src.long(), dst, 4, 4)
    with pytest.raises(ValueError, match="shape"):
        fused_conv.edge_plan(src, dst[:3], 4, 4)


def test_edge_plan_reads_every_item_count_in_one_sync(monkeypatch):
    """K1's items at 16 edges and at the smaller tiers' 8 and 4: each
    item_ptr = cumsum(ceil(deg / te)), and all their counts come back with
    the index check in one read to the host."""
    deg = np.array([0, 1, 16, 0, 17, 159])
    dst = torch.as_tensor(np.repeat(np.arange(len(deg)), deg).astype(np.int32))
    src = torch.as_tensor(np.random.default_rng(39).integers(0, 9, len(dst)).astype(np.int32))
    reads = []
    for name in ("tolist", "item", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name: reads.append(_n) or _o(self, *a))
    plan = fused_conv.edge_plan(src, dst, 9, len(deg), item_edges=(8, 4))
    monkeypatch.undo()
    assert reads == ["tolist"]
    assert sorted(plan.item_ptrs) == sorted(plan.item_counts) == [4, 8, 16]
    for te in TIER_EDGES:
        item_ptr, n_items = plan.items(te)
        np.testing.assert_array_equal(item_ptr.numpy(), np.concatenate([[0], np.cumsum(-(-deg // te))]))
        assert n_items == int((-(-deg // te)).sum())
    assert plan.n_items == 14 and plan.item_ptr is plan.item_ptrs[16]
    with pytest.raises(ValueError, match="not 2"):
        plan.items(2)
    with pytest.raises(ValueError, match="not 8"):
        fused_conv.edge_plan(src, dst, 9, len(deg)).items(8)


# ---------------------------------------------------------------- tiers

# the shared memory a block of an H100 may opt in to: 227 KiB
H100_SMEM = 232448
# each conv layer's (K1 tier, backward tier) at H100_SMEM, by storage bytes
# of sh and w; every other configuration keeps the first tiers
PRODUCTION_TIERS = ["te16+w", "te16+w+g2"]
WIDE_TIERS = {
    ("sh5", 4): [PRODUCTION_TIERS, PRODUCTION_TIERS, ["te16+w", "te16-w+g2"], ["te16-w", "te16-w+g2"]],
    ("sh5", 2): [PRODUCTION_TIERS] * 4,
    ("x2", 4): [PRODUCTION_TIERS, PRODUCTION_TIERS, ["te16-w", "te16-w+g2"], ["te16-w", "te16-w+g2"]],
    ("x2", 2): [PRODUCTION_TIERS, PRODUCTION_TIERS, ["te16+w", "te16-w+g2"], ["te16+w", "te16-w+g2"]],
    ("sh5conv5", 4): [PRODUCTION_TIERS, ["te8+w", "te8-w+g2"], ["te8+w", "te8-w+g1"], ["te8+w", "te8-w+g1"]],
    ("sh5conv5", 2): [PRODUCTION_TIERS, ["te8+w", "te8+w+g2"], ["te8+w", "te8+w+g1"], ["te8+w", "te8-w+g1"]],
}


@functools.lru_cache(maxsize=None)
def _model_conv_plans(name):
    """The conv layers' uvu plans of a configuration chip_smoke.py runs on
    the card: the production, NMR and variants models, and phase 25's."""
    import chip_smoke as cs
    from matten_tpu_torch.models import create_atomic_tensor_model, create_scalar_tensor_model

    if name == "nmr":
        model = create_atomic_tensor_model(cs.NMR_HPARAMS, cs.DATASET_HPARAMS, device="cpu")
    elif name == "variants":
        model = create_scalar_tensor_model(*cs.variant_hparams(), device="cpu")
    else:
        model = create_scalar_tensor_model(cs.WIDE_CONFIGS.get(name, cs.HPARAMS), cs.DATASET_HPARAMS,
                                           device="cpu")
    return tuple(c.uvu_plan for c in cs.conv_layers(model))


@pytest.mark.parametrize("in_bytes", [4, 2], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", ["production", "nmr", "variants", "sh5", "x2", "sh5conv5"])
def test_tier_choice_at_the_h100_limit(name, in_bytes):
    """Each conv layer's tiers from the shared-memory mirrors at an H100's
    227 KiB: the production, NMR and variants plans keep the first tiers
    (16 edges, w staged, 2 g slots); the wider ones take the first smaller
    tier that fits, as the bytes per block imply. Each tier's bytes are
    the mirror's and within the limit; the edge plan's item sizes follow."""
    plans = _model_conv_plans(name)
    expect = WIDE_TIERS.get((name, in_bytes), [PRODUCTION_TIERS] * len(plans))
    got = []
    for plan in plans:
        fwd, bwd = fused_conv.choose_tiers(plan, in_bytes, H100_SMEM)
        dims = fused_conv._smem_dims(plan)
        assert fwd.smem == fused_conv.fwd_smem(*dims, in_bytes, fwd.edges, fwd.stage_w) <= H100_SMEM
        assert bwd.smem == fused_conv.bwd_smem(*dims, in_bytes, bwd.edges, bwd.stage_w, bwd.g_slots) <= H100_SMEM
        # the first tier that fits: every earlier one is past the limit
        earlier = fused_conv.FWD_TIERS[:fused_conv.FWD_TIERS.index((fwd.edges, fwd.stage_w))]
        assert all(fused_conv.fwd_smem(*dims, in_bytes, te, sw) > H100_SMEM for te, sw in earlier)
        got.append([fwd.label("fwd"), bwd.label("bwd")])
    assert got == expect


def test_a_plan_that_fits_no_tier_raises_with_its_needs():
    """The production L3 plan under a limit below its smallest tiers: the
    choice raises, naming the bytes K1 needs at its smallest tier; one
    byte more and both kernels run their smallest tiers (4 edges, nothing
    staged but t_e, the sh rows and, for K1, the x rows)."""
    plan = _model_conv_plans("production")[-1]
    dims = fused_conv._smem_dims(plan)
    smallest = fused_conv.fwd_smem(*dims, 4, 4, False)
    with pytest.raises(ValueError, match=f"fused_uvu_conv_fwd: .* needs {smallest} B .* allows {smallest - 1} B"):
        fused_conv.choose_tiers(plan, 4, smallest - 1)
    fwd, bwd = fused_conv.choose_tiers(plan, 4, smallest)
    assert (fwd.label("fwd"), bwd.label("bwd")) == ("te4-w", "te4-w+g0")


def _replay_forward(plan, x, sh, w, edges, te=16):
    """K1's item pass at items of `te` edges read off its tables, lane by
    lane, in float64: each block finds its item (node, first edge) by the
    kernel's binary search over item_ptr; each K1 warp task's lanes
    (channel u0 + lane % nu, edges lane // nu, + ne, ...) sum their
    channel's d3 outputs over their edges, the edge groups are added, and
    pw times the sum is the item's partial row. Returns the partial rows,
    the writes to each entry, and each item's (node, first edge, edge
    count)."""
    tab, tt = fused_conv.kernel_tables(plan), fused_conv.tile_tables(plan, fwd_edges=te)
    assert tt.fwd_edges == te
    x, sh, w = (a.double().numpy() for a in (x, sh, w))
    src = edges.src.numpy()
    item_ptr, n_items = edges.items(te)
    row_ptr, item_ptr = edges.row_ptr.numpy(), item_ptr.numpy()
    sh_pad = np.where(tt.sh_src >= 0, sh[:, np.maximum(tt.sh_src, 0)], 0.0)
    t = np.zeros((sh.shape[0], tab.t_meta.shape[0]))
    for i, (_, _, d2, _) in enumerate(tab.t_meta):
        t[:, i] = sh_pad[:, tt.t_sh[i] : tt.t_sh[i] + d2] @ tt.cg_t[:d2, i]
    dout = plan.irreps_out.dim
    partial = np.zeros((n_items, dout))
    writes = np.zeros(partial.shape, int)
    spans = []
    for item in range(n_items):
        lo, hi = 0, edges.n_out
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if item_ptr[mid] <= item else (lo, mid)
        e0 = row_ptr[lo] + (item - item_ptr[lo]) * te
        nj = min(te, row_ptr[lo + 1] - e0)
        spans.append((lo, e0, nj))
        for q, gi, tu, tn in tt.fwd_tasks:
            nu, u0, n_u, ne = tu >> 16, tu & 0xFFFF, tn & 0xFFFF, tn >> 16
            assert nu & (nu - 1) == 0 and n_u <= nu and nu * ne <= 32 and ne <= te
            x_off, d1, _, _ = tt.groups[gi]
            o_off, t_off, w_off, d3 = tt.paths[q]
            for du in range(n_u):
                u = u0 + du
                lanes = []
                for dj in range(ne):
                    acc = np.zeros(d3)
                    for e in range(e0 + dj, e0 + nj, ne):
                        blk = t[e, t_off : t_off + d1 * d3].reshape(d1, d3)
                        acc += w[e, w_off + u] * (x[src[e], x_off + u * d1 : x_off + (u + 1) * d1] @ blk)
                    lanes.append(acc)
                partial[item, o_off + u * d3 : o_off + (u + 1) * d3] = tt.path_pw[q] * np.sum(lanes, 0)
                writes[item, o_off + u * d3 : o_off + (u + 1) * d3] += 1
    return partial, writes, spans


@pytest.mark.parametrize(
    "ir1,ir2,out",
    [
        (IR1, IR2, IR1),
        # 3x: a channel count that is no power of two (nu = 4, one idle lane)
        (Irreps("3x0e+2x1o"), Irreps("0e+1o+2e"), Irreps("3x0e+2x1o+1x2e")),
        (L5_IR1, L5_IR2, L5_IR1),
    ],
)
@pytest.mark.parametrize("te", TIER_EDGES)
def test_k1_item_map_and_partial_rows_reproduce_the_plain_version(ir1, ir2, out, te):
    """Destinations of degree 0, 1, 16, 0, 17 and 159 (E = 193, no multiple
    of 16), items of `te` edges: the items partition the edges in order, at
    most te edges of one destination each, ceil(deg / te) per destination;
    the replayed partial rows, each entry written once, summed per
    destination in item order, give the plain version."""
    deg = np.array([0, 1, 16, 0, 17, 159])
    n_out, n_in = len(deg), 9
    dst = np.repeat(np.arange(n_out), deg).astype(np.int32)
    _, pt, a, _ = _setup(38, n_in=n_in, n_out=n_out, e=len(dst), ir1=ir1, ir2=ir2, out=out)
    a["dst"] = dst
    t = _torch(a)
    edges = fused_conv.edge_plan(t["src"], t["dst"], n_in, n_out, item_edges=(te,))
    item_ptr, n_items = edges.items(te)
    np.testing.assert_array_equal(item_ptr.numpy(), np.concatenate([[0], np.cumsum(-(-deg // te))]))
    partial, writes, spans = _replay_forward(pt, t["x"], t["sh"], t["w"], edges, te)
    assert n_items == len(spans) == int((-(-deg // te)).sum())
    covered = np.concatenate([np.arange(e0, e0 + nj) for _, e0, nj in spans])
    np.testing.assert_array_equal(covered, np.arange(len(dst)))
    for node, e0, nj in spans:
        assert 1 <= nj <= te and (dst[e0 : e0 + nj] == node).all()
    assert (writes == 1).all()
    # index_add_ on the CPU adds the rows one after another, in item order
    item_node = torch.repeat_interleave(torch.arange(n_out), (item_ptr[1:] - item_ptr[:-1]).long())
    got = torch.zeros(n_out, partial.shape[1], dtype=torch.float64).index_add_(
        0, item_node, torch.as_tensor(partial))
    ref = fused_conv.uvu_conv_reference(pt, t["x"], t["sh"], t["w"], t["src"], t["dst"], n_out)
    np.testing.assert_allclose(got.numpy(), ref.double().numpy(), **TOL)
    assert (got[deg == 0] == 0).all()


def test_segment_sum_rejects_bad_inputs_and_counts_no_launch():
    """The segment sum checks its rows, offsets and permutation before it
    builds or launches anything; a refused call counts in neither role."""
    rows = torch.zeros(50, 5)
    ptr = torch.as_tensor(np.array([0, 0, 3, 3, 50], np.int32))
    perm = torch.arange(50, dtype=torch.int32)
    before = (fused_conv.fwd_sum_launches, fused_conv.dx_sum_launches)
    with pytest.raises(TypeError):
        fused_conv._segment_sum(rows.double(), ptr, None, 4)
    with pytest.raises(TypeError):
        fused_conv._segment_sum(rows, ptr.long(), perm, 4)
    with pytest.raises(ValueError, match="shape"):
        fused_conv._segment_sum(rows, ptr, None, 5)
    with pytest.raises(ValueError, match="shape"):
        fused_conv._segment_sum(rows, ptr, perm[:49], 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv._segment_sum(torch.zeros(5, 50).t(), ptr, perm, 4)
    assert (fused_conv.fwd_sum_launches, fused_conv.dx_sum_launches) == before


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
    dx, dw = fused_conv.uvu_conv_bwd(pt, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], x.shape[0])
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


def _replay_backward(plan, x, g, sh, w, src, dst, n_in, te=16):
    """The merged backward kernel's arithmetic read off its tables, lane by
    lane, in float64: tiles of `te` edges (the last one partial);
    t_e = CG blocks . sh from `cg_t` and the sh rows padded per irrep to 4
    floats (`sh_src`, `t_sh`); each warp's tasks, each lane = (channel
    u0 + lane % nu, edge j0 + lane // nu) over its irrep's paths (Y, dw and
    the channel's dx); then the segment sum over `src_order`. Also counts
    the writes to every entry of dxe and dw."""
    tab, bt = fused_conv.kernel_tables(plan), fused_conv.tile_tables(plan, bwd_edges=te)
    assert bt.bwd_edges == te
    order = fused_conv.src_order(src, n_in)
    x, g, sh, w = (a.double().numpy() for a in (x, g, sh, w))
    src, dst = src.numpy(), dst.numpy()
    n_e, d1 = sh.shape[0], x.shape[1]
    sh_pad = np.where(bt.sh_src >= 0, sh[:, np.maximum(bt.sh_src, 0)], 0.0)
    t = np.zeros((n_e, tab.t_meta.shape[0]))
    for i, (_, _, d2, _) in enumerate(tab.t_meta):
        assert bt.t_sh[i] % 4 == 0
        t[:, i] = sh_pad[:, bt.t_sh[i] : bt.t_sh[i] + d2] @ bt.cg_t[:d2, i]
    dxe, dw = np.zeros((n_e, d1)), np.zeros_like(w)
    writes_dxe, writes_dw = np.zeros(dxe.shape, int), np.zeros(dw.shape, int)
    for tile0 in range(0, n_e, te):
        nj = min(te, n_e - tile0)
        for k in range(bt.warp_ptr[-1]):
            tu, grp, tz, tj = (int(v) for v in bt.tasks[k])
            nu, u_count = tu >> 16, tz & 0xFFFF
            x_off, gd1, q0, q1 = (int(v) for v in bt.groups[grp])
            # the generic path's flag: d1 or a path's d3 above the unrolled ones
            assert tz >> 16 == (max([gd1] + [int(bt.paths[q][3]) for q in range(q0, q1)])
                                > fused_conv.CONV_MAX_D)
            assert (tj & 0xFFFF) < te and (tj >> 16) <= te
            for lane in range(32):
                du, dj = lane % nu, lane // nu
                j = (tj & 0xFFFF) + dj
                if du >= u_count or dj >= tj >> 16 or j >= nj:
                    continue
                u, e = (tu & 0xFFFF) + du, tile0 + j
                xb = x_off + u * gd1
                dxv = np.zeros(gd1)
                for q in range(q0, q1):
                    o_off, t_off, w_off, d3 = (int(v) for v in bt.paths[q])
                    y = t[e, t_off : t_off + gd1 * d3].reshape(gd1, d3) @ g[dst[e], o_off + u * d3 : o_off + (u + 1) * d3]
                    dw[e, w_off + u] = bt.path_pw[q] * (x[src[e], xb : xb + gd1] @ y)
                    writes_dw[e, w_off + u] += 1
                    dxv += bt.path_pw[q] * w[e, w_off + u] * y
                dxe[e, xb : xb + gd1] = dxv
                writes_dxe[e, xb : xb + gd1] += 1
    perm, row_ptr = order.perm.numpy(), order.row_ptr.numpy()
    dx = np.stack([dxe[perm[row_ptr[n] : row_ptr[n + 1]]].sum(0) for n in range(n_in)])
    return dx, dw, writes_dxe, writes_dw


@pytest.mark.parametrize(
    "ir1,ir2,out",
    [
        (IR1, IR2, IR1),
        (
            Irreps("4x0e+4x0o+2x1o+2x1e+1x2e+1x2o"),
            Irreps("0e+1o+2e"),
            Irreps("4x0o+4x0e+2x1o+2x1e+1x2o+1x2e"),
        ),
        (L5_IR1, L5_IR2, L5_IR1),
    ],
)
@pytest.mark.parametrize("te", TIER_EDGES)
def test_backward_tables_reproduce_the_plain_versions(ir1, ir2, out, te):
    """42 edges in tiles of `te`: full tiles and a partial one at every
    tile size; n_in != n_out."""
    _, pt, a, n = _setup(33, n_in=7, n_out=5, e=42, ir1=ir1, ir2=ir2, out=out)
    t = _torch(a)
    g = torch.as_tensor(np.random.default_rng(34).normal(size=(n, pt.irreps_out.dim)).astype(np.float32))
    dx, dw, writes_dxe, writes_dw = _replay_backward(pt, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], 7, te)
    dx_ref, dw_ref = fused_conv.uvu_conv_bwd_reference(pt, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], 7)
    np.testing.assert_allclose(dx, dx_ref.numpy(), **TOL)
    np.testing.assert_allclose(dw, dw_ref.numpy(), **TOL)
    # every (channel, edge) and every (edge, weight) has exactly one writer
    assert (writes_dxe == 1).all() and (writes_dw == 1).all()
    bt = fused_conv.tile_tables(pt)
    assert len(bt.paths) == len(pt.instructions)
    assert len(bt.warp_ptr) == fused_conv.BWD_WARPS + 1


def test_src_order_is_a_stable_argsort_with_csr_offsets():
    src = torch.as_tensor(np.random.default_rng(37).integers(0, 6, 50).astype(np.int32))
    order = fused_conv.src_order(src, 8)
    assert order.perm.dtype == order.row_ptr.dtype == torch.int32
    np.testing.assert_array_equal(order.perm.numpy(), np.argsort(src.numpy(), kind="stable"))
    np.testing.assert_array_equal(order.row_ptr.numpy(), np.searchsorted(np.sort(src.numpy()), np.arange(9)))


@pytest.mark.parametrize("n_in,n_out", [(24, 24), (32, 16)])
def test_backward_wrappers_on_cpu_run_the_plain_versions(n_in, n_out):
    _, pt, a, n = _setup(35, n_in=n_in, n_out=n_out)
    t = _torch(a)
    g = torch.ones(n, pt.irreps_out.dim)
    args = (pt, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], n_in)
    before = (fused_conv.bwd_launches, fused_conv.dx_sum_launches)
    dx, dw = fused_conv.uvu_conv_bwd(*args)
    assert (fused_conv.bwd_launches, fused_conv.dx_sum_launches) == before
    dx_ref, dw_ref = fused_conv.uvu_conv_bwd_reference(*args)
    assert dx.shape == (n_in, pt.irreps_in1.dim) and dw.shape == (96, pt.weight_numel)
    assert torch.equal(dx, dx_ref) and torch.equal(dw, dw_ref)


def test_backward_launches_reject_bad_inputs():
    _, pt, a, n = _setup(36)
    t = _torch(a)
    g = torch.ones(n, pt.irreps_out.dim)

    def launch(g=g, dst=t["dst"]):
        fused_conv._launch_bwd(pt, t["x"], g, t["sh"], t["w"], fused_conv.edge_plan(t["src"], dst, 24, n))

    with pytest.raises(TypeError):
        launch(g=g.double())
    with pytest.raises(ValueError, match="shape"):
        launch(g=g[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        launch(g=g.t().contiguous().t())
    with pytest.raises(ValueError, match="non-decreasing"):
        launch(dst=t["dst"].flip(0).contiguous())
