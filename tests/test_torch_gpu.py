"""The port's CUDA kernels on the card, held against their plain PyTorch versions.

Marked `gpu`; each test skips without a CUDA device (the kernels have no CPU
mode). The GPU machine has no JAX, and tests/conftest.py imports it, so run
this file there without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: K1 vs plain rtol=atol=1e-5 (float32, another summation
order); the backward kernels' dx and dw, K1 at the production plans and the
segment sum vs index_add_ max|d| <= 1e-5 max|ref| (their sums run over many
edges and paths of both signs, so single small entries cancel); two runs of
K1 and of the backward kernels bitwise equal (no atomics, fixed order); the
model, 2 conv layers deep, 1e-4, its parameter gradients 1e-4 relative to
each parameter's largest gradient; the per-atom model at the NMR
configuration's width 1e-4; `predict` from a checkpoint directory equal to
the in-memory `predict` of the same weights within 1e-6 relative; K1 and
the merged backward at bf16 storage of sh and w against their plain
versions at the same rounding with K1's tolerance (both read the same
rounded inputs). The 2-rank nccl steps need two cards and skip with fewer,
naming the count found; they import `chip_smoke` from the repository's
root, from which pytest runs.
"""

import os

import numpy as np
import pytest
import torch

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.kernels import fused_conv
from matten_tpu_torch.ops.tensor_product import uvu_tp_plan

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-5, atol=1e-5)
IR1, IR2 = Irreps("8x0e+4x1o+2x2e+1x3o"), Irreps("0e+1o+2e+3o")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_rel(out, ref, tol=1e-5):
    err = float((out - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), (err, float(ref.abs().max()))


def _inputs(dev, seed, n_in, n_out, e):
    rng = np.random.default_rng(seed)
    plan = uvu_tp_plan(IR1, IR2, IR1)
    arrs = dict(
        x=rng.normal(size=(n_in, IR1.dim)).astype(np.float32),
        sh=rng.normal(size=(e, IR2.dim)).astype(np.float32),
        w=rng.normal(size=(e, plan.weight_numel)).astype(np.float32),
        src=rng.integers(0, n_in, e).astype(np.int32),
        # leave some nodes without edges: their rows must come out zero
        dst=np.sort(rng.integers(0, max(n_out - 3, 1), e)).astype(np.int32),
    )
    return plan, {k: torch.as_tensor(v, device=dev) for k, v in arrs.items()}


# (40, 16): halo-style n_in > n_out; (2600, 2600): beyond the JAX v2
# kernel's RESIDENT_NODES_MAX = 2048, where JAX falls back to the v1 kernel
@pytest.mark.parametrize(
    "n_in,n_out,e", [(24, 24, 300), (40, 16, 500), (7, 5, 1), (2600, 2600, 40000)]
)
def test_kernel_matches_plain(dev, n_in, n_out, e):
    plan, t = _inputs(dev, 1, n_in, n_out, e)
    args = (plan, t["x"], t["sh"], t["w"], t["src"], t["dst"], n_out)
    before = fused_conv.launches
    out = fused_conv.fused_uvu_conv(*args)
    torch.cuda.synchronize()
    assert fused_conv.launches == before + 1
    ref = fused_conv.uvu_conv_reference(*args)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    assert bool((out[n_out - 3 :] == 0).all())
    with fused_conv.force_plain():
        forced = fused_conv.fused_uvu_conv(*args)
    assert fused_conv.launches == before + 1
    # the plain version sums with atomics on the card: equal up to order
    np.testing.assert_allclose(forced.cpu().numpy(), ref.cpu().numpy(), **TOL)


def test_kernel_rejects_bad_inputs(dev):
    plan, t = _inputs(dev, 2, 24, 24, 100)
    with pytest.raises(ValueError, match="non-decreasing"):
        fused_conv.fused_uvu_conv(
            plan, t["x"], t["sh"], t["w"], t["src"], t["dst"].flip(0).contiguous(), 24
        )
    with pytest.raises(ValueError, match="src in"):
        fused_conv.fused_uvu_conv(plan, t["x"], t["sh"], t["w"], (t["src"] + 24).contiguous(), t["dst"], 24)
    with pytest.raises(ValueError, match="mixed devices"):
        fused_conv.fused_uvu_conv(plan, t["x"].cpu(), t["sh"], t["w"], t["src"], t["dst"], 24)


# the production elasticity model's conv layers (scripts/configs/
# materials_tensor_production.yaml): their 4 uvu plans
PRODUCTION = dict(
    species_embedding_dim=16, irreps_edge_sh="0e+1o+2e+3o+4e", num_radial_basis=8,
    radial_basis_start=0.0, radial_basis_end=5.0, radial_basis_type="bessel", num_layers=3,
    invariant_layers=2, invariant_neurons=32, average_num_neighbors=30.0,
    conv_layer_irreps="32x0o+32x0e+16x1o+16x1e+4x2o+4x2e+2x3o+2x3e+2x4e",
    nonlinearity_type="gate", normalization="batch",
    conv_to_output_hidden_irreps_out="16x0e+2x2e+4e", output_format="irreps",
    output_formula="ijkl=jikl=klij", reduce="mean",
)


# the per-atom NMR model (scripts/configs/atomic_tensor.yaml): SH lmax 2,
# conv irreps up to l = 2
NMR = dict(
    species_embedding_dim=16, irreps_edge_sh="0e+1o+2e", num_radial_basis=8,
    radial_basis_start=0.0, radial_basis_end=5.0, radial_basis_type="bessel", num_layers=3,
    invariant_layers=2, invariant_neurons=32, average_num_neighbors=30.0,
    conv_layer_irreps="32x0o+32x0e+16x1o+16x1e+4x2o+4x2e", nonlinearity_type="gate",
    normalization="batch", output_format="irreps", output_formula="ij=ji",
)
SPECIES_5 = (8, 13, 14, 22, 56)


def _conv_plans(model):
    from matten_tpu_torch.nn.conv import PointConv, PointConvWithActivation

    return [m.conv.uvu_plan if isinstance(m, PointConvWithActivation) else m.uvu_plan
            for m in model.backbone.layers if isinstance(m, (PointConv, PointConvWithActivation))]


def _production_plans(dev):
    from matten_tpu_torch.models import create_scalar_tensor_model

    return _conv_plans(create_scalar_tensor_model(PRODUCTION, dict(allowed_species=list(SPECIES_5)), device=dev))


def _nmr_plans(dev):
    from matten_tpu_torch.models import create_atomic_tensor_model

    return _conv_plans(create_atomic_tensor_model(NMR, dict(allowed_species=list(SPECIES_5)), device=dev))


def _check_backward(plan, t, g, n_in):
    """uvu_conv_bwd (one launch of each kernel) and the autograd backward
    of K1 against the plain backward; returns (dx, dw)."""
    args = (plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], n_in)
    before = (fused_conv.bwd_launches, fused_conv.dx_sum_launches)
    dx, dw = fused_conv.uvu_conv_bwd(*args)
    torch.cuda.synchronize()
    assert (fused_conv.bwd_launches, fused_conv.dx_sum_launches) == (before[0] + 1, before[1] + 1)
    dx_ref, dw_ref = fused_conv.uvu_conv_bwd_reference(*args)
    _assert_rel(dx, dx_ref)
    _assert_rel(dw, dw_ref)
    return dx, dw


def _inputs_on_graph(dev, seed, plan, n_in, src, dst):
    rng = np.random.default_rng(seed)
    e = len(dst)
    arrs = dict(
        x=rng.normal(size=(n_in, plan.irreps_in1.dim)).astype(np.float32),
        sh=rng.normal(size=(e, plan.irreps_in2.dim)).astype(np.float32),
        w=rng.normal(size=(e, plan.weight_numel)).astype(np.float32),
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
    )
    return {k: torch.as_tensor(v, device=dev) for k, v in arrs.items()}


# edge counts 300 and 500 are no multiple of the 16-edge tile; (40, 16):
# n_in != n_out; (2600, 2600, 166400): beyond the JAX v2 kernel's
# RESIDENT_NODES_MAX = 2048, where JAX falls back to the v1 kernels K3 and K4
@pytest.mark.parametrize(
    "n_in,n_out,e", [(24, 24, 300), (40, 16, 500), (7, 5, 1), (2600, 2600, 166400)]
)
def test_backward_kernels_match_plain(dev, n_in, n_out, e):
    plan, t = _inputs(dev, 3, n_in, n_out, e)
    g = torch.randn(n_out, plan.irreps_out.dim, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    _check_backward(plan, t, g, n_in)
    dx_ref, dw_ref = fused_conv.uvu_conv_bwd_reference(
        plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], n_in)
    # the autograd backward of K1 launches the same kernels (dsh by the plain version)
    before = (fused_conv.bwd_launches, fused_conv.dx_sum_launches)
    x, sh, w = (t[k].clone().requires_grad_() for k in ("x", "sh", "w"))
    out = fused_conv.fused_uvu_conv(plan, x, sh, w, t["src"], t["dst"], n_out)
    out.backward(g)
    assert (fused_conv.bwd_launches, fused_conv.dx_sum_launches) == (before[0] + 1, before[1] + 1)
    _assert_rel(x.grad, dx_ref)
    _assert_rel(w.grad, dw_ref)
    with torch.enable_grad():
        s2 = t["sh"].clone().requires_grad_()
        ref = fused_conv.uvu_conv_reference(plan, t["x"], s2, t["w"], t["src"], t["dst"], n_out)
        (dsh_ref,) = torch.autograd.grad(ref, s2, g)
    _assert_rel(sh.grad, dsh_ref, 1e-4)


def test_backward_kernels_match_plain_at_production_plans(dev):
    """The 4 production plans on a flagship-sized random graph (N=320,
    E=21504, dst sorted), and the last one on degree-1 destinations: every
    tile then has 16 destinations, 14 of them read from the cache."""
    rng = np.random.default_rng(6)
    n, e = 320, 21504
    src, dst = rng.integers(0, n, e), np.sort(rng.integers(0, n, e))
    plans = _production_plans(dev)
    for i, plan in enumerate(plans):
        t = _inputs_on_graph(dev, 10 + i, plan, n, src, dst)
        g = torch.as_tensor(rng.normal(size=(n, plan.irreps_out.dim)).astype(np.float32), device=dev)
        _check_backward(plan, t, g, n)
    e1 = 3000
    t = _inputs_on_graph(dev, 20, plans[-1], n, rng.integers(0, n, e1), np.arange(e1))
    g = torch.as_tensor(rng.normal(size=(e1, plans[-1].irreps_out.dim)).astype(np.float32), device=dev)
    _check_backward(plans[-1], t, g, n)


def test_backward_kernels_are_bitwise_deterministic(dev):
    plan = _production_plans(dev)[-1]
    rng = np.random.default_rng(7)
    n, e = 320, 21504
    t = _inputs_on_graph(dev, 8, plan, n, rng.integers(0, n, e), np.sort(rng.integers(0, n, e)))
    g = torch.as_tensor(rng.normal(size=(n, plan.irreps_out.dim)).astype(np.float32), device=dev)
    dx, dw = _check_backward(plan, t, g, n)
    dx2, dw2 = fused_conv.uvu_conv_bwd(plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], n)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


# bf16 storage of sh and w: dw = 76 (rows 152 bytes: 16-byte copies start
# mid-row) and dw = 31 (rows 62 bytes: most rows start off 4-byte alignment,
# so each run has a bf16 element copied alone at each end)
@pytest.mark.parametrize("ir1,ir2", [(IR1, IR2), (Irreps("5x0e+3x1o+1x2e"), Irreps("0e+1o+2e"))],
                         ids=["dw76", "dw31"])
def test_bf16_storage_kernels_match_their_plain_versions(dev, ir1, ir2):
    """At `set_kernel_in_dtype("bfloat16")` K1 and the merged backward read
    sh and w in bf16 and are held to the plain versions at the same rounding
    with the float32 tolerance (both sides read the same rounded inputs);
    two runs bitwise equal; only the bf16 counters move; dw float32."""
    from matten_tpu_torch.kernels import fused_tp

    rng = np.random.default_rng(31)
    plan = uvu_tp_plan(ir1, ir2, ir1)
    n, e = 40, 777
    t = _inputs_on_graph(dev, 32, plan, n, rng.integers(0, n, e), np.sort(rng.integers(0, n - 3, e)))
    g = torch.as_tensor(rng.normal(size=(n, plan.irreps_out.dim)).astype(np.float32), device=dev)
    args = (plan, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
    bargs = (plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], n)
    f32 = (fused_conv.launches, fused_conv.bwd_launches)
    before = (fused_conv.bf16_launches, fused_conv.bf16_bwd_launches)
    fused_tp.set_kernel_in_dtype("bfloat16")
    try:
        out, out2 = fused_conv.fused_uvu_conv(*args), fused_conv.fused_uvu_conv(*args)
        (dx, dw), (dx2, dw2) = fused_conv.uvu_conv_bwd(*bargs), fused_conv.uvu_conv_bwd(*bargs)
        torch.cuda.synchronize()
        ref = fused_conv.uvu_conv_reference(*args)
        dx_ref, dw_ref = fused_conv.uvu_conv_bwd_reference(*bargs)
    finally:
        fused_tp.set_kernel_in_dtype("float32")
    assert (fused_conv.bf16_launches, fused_conv.bf16_bwd_launches) == (before[0] + 2, before[1] + 2)
    assert (fused_conv.launches, fused_conv.bwd_launches) == f32
    assert dw.dtype == torch.float32
    _assert_rel(out, ref)
    _assert_rel(dx, dx_ref)
    _assert_rel(dw, dw_ref)
    assert torch.equal(out, out2) and torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert not torch.equal(out, fused_conv.uvu_conv_reference(*args))  # float32 storage


def test_k1_matches_plain_and_is_bitwise_deterministic_at_production_plans(dev):
    """K1 (item pass and partial-row sum) at the 4 production plans on a
    flagship-sized random graph (N=320, E=21504) and at N=2600 with the
    last plan: against the plain version, and two runs bitwise equal."""
    rng = np.random.default_rng(11)
    plans = _production_plans(dev)
    cases = [(plan, 320, 21504) for plan in plans] + [(plans[-1], 2600, 2600 * 64)]
    for i, (plan, n, e) in enumerate(cases):
        t = _inputs_on_graph(dev, 30 + i, plan, n, rng.integers(0, n, e), np.sort(rng.integers(0, n, e)))
        args = (plan, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
        edges = fused_conv.edge_plan(t["src"], t["dst"], n, n)
        before = (fused_conv.launches, fused_conv.fwd_sum_launches)
        out = fused_conv.fused_uvu_conv(*args, edges)
        out2 = fused_conv.fused_uvu_conv(*args, edges)
        torch.cuda.synchronize()
        assert (fused_conv.launches, fused_conv.fwd_sum_launches) == (before[0] + 2, before[1] + 2)
        assert torch.equal(out, out2)
        _assert_rel(out, fused_conv.uvu_conv_reference(*args))
        del t, out, out2


def test_k1_skewed_degrees(dev):
    """One destination with 3000 edges (188 items), destinations without
    edges (their rows must be 0), E = 3000 + 1237, no multiple of 16, and
    n_in != n_out; the last production plan."""
    plan = _production_plans(dev)[-1]
    rng = np.random.default_rng(12)
    n_in, n_out = 50, 40
    dst = np.sort(np.concatenate([np.full(3000, 17), rng.integers(20, 35, 1237)]))
    t = _inputs_on_graph(dev, 13, plan, n_in, rng.integers(0, n_in, len(dst)), dst)
    args = (plan, t["x"], t["sh"], t["w"], t["src"], t["dst"], n_out)
    edges = fused_conv.edge_plan(t["src"], t["dst"], n_in, n_out)
    out = fused_conv.fused_uvu_conv(*args, edges)
    torch.cuda.synchronize()
    _assert_rel(out, fused_conv.uvu_conv_reference(*args))
    empty = np.setdiff1d(np.arange(n_out), dst)
    assert len(empty) == 24 and bool((out[torch.as_tensor(empty, device=dev)] == 0).all())
    assert torch.equal(out, fused_conv.fused_uvu_conv(*args, edges))


@pytest.mark.parametrize("width", [1, 16, 246, 4170, 400, 7])
def test_segment_sum_matches_index_add_in_both_roles(dev, width):
    """The shared segment sum: dx rows over a stable src order (rows [E,
    width] into n_in nodes) and K1's partial rows over item offsets with
    empty segments, against index_add_ of the same rows; widths that take
    its 4-, 8- and 16-byte loads; two runs bitwise equal."""
    rng = np.random.default_rng(width)
    e, n_in = 3000, 70
    src = torch.as_tensor(rng.integers(0, n_in - 5, e).astype(np.int32), device=dev)
    rows = torch.as_tensor(rng.normal(size=(e, width)).astype(np.float32), device=dev)
    order = fused_conv.src_order(src, n_in)
    before = fused_conv.dx_sum_launches
    dx = fused_conv._launch_dx_sum(rows, order, n_in)
    assert fused_conv.dx_sum_launches == before + 1
    ref = torch.zeros(n_in, width, device=dev).index_add_(0, src.long(), rows)
    _assert_rel(dx, ref)
    assert torch.equal(dx, fused_conv._launch_dx_sum(rows, order, n_in))
    assert bool((dx[n_in - 5 :] == 0).all())
    counts = rng.integers(0, 12, 300)
    counts[rng.integers(0, 300, 30)] = 0
    ptr = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32), device=dev)
    part = rows[: int(counts.sum())].contiguous()
    seg = torch.repeat_interleave(torch.arange(300, device=dev), torch.as_tensor(counts, device=dev))
    before = (fused_conv.fwd_sum_launches, fused_conv.dx_sum_launches)
    out = fused_conv._segment_sum(part, ptr, None, 300)
    assert (fused_conv.fwd_sum_launches, fused_conv.dx_sum_launches) == (before[0] + 1, before[1])
    _assert_rel(out, torch.zeros(300, width, device=dev).index_add_(0, seg, part))
    assert bool((out[torch.as_tensor(counts == 0, device=dev)] == 0).all())


@pytest.mark.parametrize("te", [16, 8, 4])
def test_k1_and_backward_with_an_edge_plan_do_not_sync(dev, te):
    """Given the batch's edge plan, K1's launches and the backward's run
    without a host sync (torch.cuda.set_sync_debug_mode("error") raises on
    one), at K1 items of `te` edges (a smaller tier forced by a smaller
    shared-memory limit); the first calls, which build the kernels and
    copy the plan's tables to the card, run before."""
    plan, t = _inputs(dev, 14, 300, 300, 5000)
    dims = fused_conv._smem_dims(plan)
    limit = None if te == 16 else fused_conv.fwd_smem(*dims, 4, te, True)
    g = torch.randn(300, plan.irreps_out.dim, device=dev)
    args = (plan, t["x"], t["sh"], t["w"], t["src"], t["dst"])
    with fused_conv.smem_limit(limit):
        assert fused_conv.launch_tiers(plan, dev)[0].edges == te
        edges = fused_conv.edge_plan(t["src"], t["dst"], 300, 300, with_src_order=True,
                                     item_edges=fused_conv.item_edges_for((plan,), dev))
        fused_conv.fused_uvu_conv(*args, 300, edges)
        fused_conv.uvu_conv_bwd(plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], 300, edges)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fused_conv.fused_uvu_conv(*args, 300, edges)
            dx, dw = fused_conv.uvu_conv_bwd(plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], 300, edges)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_allclose(out.cpu().numpy(), fused_conv.uvu_conv_reference(*args, 300).cpu().numpy(), **TOL)
    dx_ref, dw_ref = fused_conv.uvu_conv_bwd_reference(plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], 300)
    _assert_rel(dx, dx_ref)
    _assert_rel(dw, dw_ref)


# the kernels' generic paths: d1 and d3 up to 11, an sh irrep of 11
L5_IR1, L5_IR2 = Irreps("2x0e+1x1o+1x5o+1x5e"), Irreps("0e+1o+2e+3o+4e+5o")


def _tier_plans(dev):
    """A plan above l=4, and the last conv layer of chip_smoke.py's "x2"
    configuration (the production multiplicities doubled)."""
    import chip_smoke as cs
    from matten_tpu_torch.models import create_scalar_tensor_model

    x2 = create_scalar_tensor_model(cs.WIDE_CONFIGS["x2"], dict(allowed_species=list(SPECIES_5)), device=dev)
    return {"l5": uvu_tp_plan(L5_IR1, L5_IR2, L5_IR1), "x2": _conv_plans(x2)[-1]}


def _tier_limits(plan, in_bytes, optin):
    """Every tier's bytes per block up to the device's opt-in limit, largest
    first: under each as the limit the tier choice takes that tier or a
    smaller one."""
    dims = fused_conv._smem_dims(plan)
    limits = {fused_conv.fwd_smem(*dims, in_bytes, te, sw) for te, sw in fused_conv.FWD_TIERS}
    limits |= {fused_conv.bwd_smem(*dims, in_bytes, te, sw, g)
               for te, g in fused_conv.BWD_TIERS for sw in (False, True)}
    return sorted((b for b in limits if b <= optin), reverse=True)


@pytest.mark.parametrize("in_bytes", [4, 2], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", ["l5", "x2"])
def test_every_tier_matches_plain_and_is_bitwise_deterministic(dev, name, in_bytes):
    """K1 (item pass and sum) and the merged backward (dx and dw) at each
    tier a smaller shared-memory limit forces (`smem_limit`): against their
    plain versions at the same storage rounding, two runs bitwise equal,
    one launch counted at the tier the choice names. The limits reach every
    K1 tier that fits the device, every tile size and g-slot count of the
    backward, and the backward with and without its w rows staged."""
    from matten_tpu_torch.kernels import fused_tp

    plan = _tier_plans(dev)[name]
    rng = np.random.default_rng(41)
    n = 48
    # degrees up to ~100: items of every size span several per destination
    dst = np.sort(np.concatenate([rng.integers(0, n - 4, 1500), np.full(97, 5)]))
    t = _inputs_on_graph(dev, 42, plan, n, rng.integers(0, n, len(dst)), dst)
    g = torch.as_tensor(rng.normal(size=(n, plan.irreps_out.dim)).astype(np.float32), device=dev)
    args = (plan, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
    bargs = (plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], n)
    kind = "" if in_bytes == 4 else "_bf16"
    ran = {"fwd": set(), "bwd": set()}
    fused_tp.set_kernel_in_dtype("float32" if in_bytes == 4 else "bfloat16")
    try:
        ref = fused_conv.uvu_conv_reference(*args)
        dx_ref, dw_ref = fused_conv.uvu_conv_bwd_reference(*bargs)
        optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
        for limit in _tier_limits(plan, in_bytes, optin):
            try:
                fwd, bwd = fused_conv.choose_tiers(plan, in_bytes, limit)
            except ValueError:
                continue
            labels = (("fwd" + kind, fwd.label("fwd")), ("bwd" + kind, bwd.label("bwd")))
            before = [fused_conv.tier_launches[k] for k in labels]
            with fused_conv.smem_limit(limit):
                assert fused_conv.launch_tiers(plan, dev) == (fwd, bwd)
                edges = fused_conv.edge_plan(t["src"], t["dst"], n, n, with_src_order=True,
                                             item_edges=fused_conv.item_edges_for((plan,), dev))
                out, out2 = (fused_conv.fused_uvu_conv(*args, edges) for _ in range(2))
                (dx, dw), (dx2, dw2) = (fused_conv.uvu_conv_bwd(*bargs, edges) for _ in range(2))
            torch.cuda.synchronize()
            assert [fused_conv.tier_launches[k] for k in labels] == [b + 2 for b in before], (limit, labels)
            _assert_rel(out, ref)
            _assert_rel(dx, dx_ref)
            _assert_rel(dw, dw_ref)
            assert torch.equal(out, out2) and torch.equal(dx, dx2) and torch.equal(dw, dw2)
            ran["fwd"].add((fwd.edges, fwd.stage_w))
            ran["bwd"].add((bwd.edges, bwd.stage_w, bwd.g_slots))
    finally:
        fused_tp.set_kernel_in_dtype("float32")
    dims = fused_conv._smem_dims(plan)
    assert ran["fwd"] == {(te, sw) for te, sw in fused_conv.FWD_TIERS
                          if fused_conv.fwd_smem(*dims, in_bytes, te, sw) <= optin}
    assert {te for te, _, _ in ran["bwd"]} == {16, 8, 4}
    assert {g for _, _, g in ran["bwd"]} == {2, 1, 0}
    assert {sw for _, sw, _ in ran["bwd"]} == {True, False}


def test_smem_mirrors_match_the_library(dev):
    """The Python mirrors of the kernels' shared-memory needs equal the C
    library's at every tier, for the production, l=5 and x2 plans at both
    storage widths; the device's tiers are the mirror's choice at its
    opt-in limit."""
    from matten_tpu_torch.kernels._build import load_library

    lib = load_library()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    plans = [*_production_plans(dev), *_tier_plans(dev).values()]
    for plan in plans:
        dims = fused_conv._smem_dims(plan)
        for in_bytes in (4, 2):
            for te in (16, 8, 4):
                for sw in (False, True):
                    assert lib.fused_uvu_conv_fwd_smem(*dims, in_bytes, te, sw, 0) == \
                        fused_conv.fwd_smem(*dims, in_bytes, te, sw)
                    for g in (0, 1, 2):
                        assert lib.fused_uvu_conv_bwd_smem(*dims, in_bytes, te, sw, g) == \
                            fused_conv.bwd_smem(*dims, in_bytes, te, sw, g)
            assert fused_conv.launch_tiers(plan, dev, in_bytes) == fused_conv.choose_tiers(plan, in_bytes, limit)
    # every production plan runs the first tiers
    for plan in _production_plans(dev):
        fwd, bwd = fused_conv.launch_tiers(plan, dev, 4)
        assert (fwd.label("fwd"), bwd.label("bwd")) == ("te16+w", "te16+w+g2")


def test_a_plan_past_every_tier_raises_before_launching(dev):
    """Under a limit below K1's smallest tier the wrapper raises, naming
    the bytes, and launches nothing."""
    plan, t = _inputs(dev, 43, 24, 24, 300)
    smallest = fused_conv.fwd_smem(*fused_conv._smem_dims(plan), 4, 4, False)
    before = (fused_conv.launches, fused_conv.fwd_sum_launches, sum(fused_conv.tier_launches.values()))
    with fused_conv.smem_limit(smallest - 1):
        with pytest.raises(ValueError, match=f"needs {smallest} B of shared memory"):
            fused_conv.fused_uvu_conv(plan, t["x"], t["sh"], t["w"], t["src"], t["dst"], 24)
    assert (fused_conv.launches, fused_conv.fwd_sum_launches, sum(fused_conv.tier_launches.values())) == before


def test_backward_kernels_reject_bad_inputs(dev):
    plan, t = _inputs(dev, 4, 24, 24, 100)
    g = torch.ones(24, plan.irreps_out.dim, device=dev)
    with pytest.raises(ValueError, match="non-decreasing"):
        fused_conv.uvu_conv_bwd(plan, t["x"], g, t["sh"], t["w"], t["src"],
                                t["dst"].flip(0).contiguous(), 24)
    with pytest.raises(ValueError, match="mixed devices"):
        fused_conv.uvu_conv_bwd(plan, t["x"], g.cpu(), t["sh"], t["w"], t["src"], t["dst"], 24)


def test_debug_forward_on_the_card_raises_on_a_nan(dev):
    """A model built at DEBUG log level checks every layer's output on the
    card: finite inputs pass, a NaN put into one node feature after the
    first layer raises naming the field and the layer."""
    from matten_tpu_torch.data.graph import CrystalGraph, collate_graphs, pad_spec_for
    from matten_tpu_torch.data.structure import Structure
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.predict import batch_to_device
    from matten_tpu_torch.utils import logging as plogging

    species = (8, 14)
    hp = dict(species_embedding_dim=4, irreps_edge_sh="0e+1o+2e", num_layers=1, invariant_layers=1,
              invariant_neurons=4, average_num_neighbors=20.0, conv_layer_irreps="2x0e+1x1o+1x2e",
              normalization="batch", conv_to_output_hidden_irreps_out="2x0e+2e+4e")
    prev = plogging.get_log_level()
    plogging.set_logger("DEBUG", filename=None)
    try:
        model = create_scalar_tensor_model(hp, dict(allowed_species=list(species)), device=dev).eval()
    finally:
        plogging.set_logger(prev, filename=None)
    rng = np.random.default_rng(5)
    graphs = [CrystalGraph.from_structure(
        Structure(lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1,
                  frac_coords=rng.uniform(0, 1, size=(4, 3)), atomic_numbers=rng.choice(species, size=4)),
        r_cut=5.0) for _ in range(2)]
    data, _ = collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(species))
    data = batch_to_device(data, dev)
    with torch.inference_mode():
        assert torch.isfinite(model(data)).all()

    def poison(_module, _inputs, out):
        out[K.NODE_FEATURES][0, 0] = float("nan")
        return out

    model.backbone.layers[0].register_forward_hook(poison)
    with pytest.raises(FloatingPointError, match="field 'node_features' after species_embedding"):
        with torch.inference_mode():
            model(data)


def test_model_forward_through_kernel(dev):
    from matten_tpu_torch.data.graph import CrystalGraph, collate_graphs, pad_spec_for
    from matten_tpu_torch.data.structure import Structure
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.predict import batch_to_device

    species = (8, 13, 14, 22, 56)
    hp = dict(
        species_embedding_dim=8, irreps_edge_sh="0e+1o+2e+3o+4e", num_layers=2,
        invariant_layers=2, invariant_neurons=8, average_num_neighbors=30.0,
        conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+1x2o+1x2e+1x3o+1x3e+1x4e",
        normalization="batch", conv_to_output_hidden_irreps_out="4x0e+2x2e+4e",
    )
    model = create_scalar_tensor_model(hp, dict(allowed_species=list(species)), device=dev).eval()
    rng = np.random.default_rng(4)
    graphs = [
        CrystalGraph.from_structure(
            Structure(
                lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1,
                frac_coords=rng.uniform(0, 1, size=(5, 3)),
                atomic_numbers=rng.choice(species, size=5),
            ),
            r_cut=5.0,
        )
        for _ in range(3)
    ]
    data, _ = collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(species))
    data = batch_to_device(data, dev)
    before = (fused_conv.launches, fused_conv.fwd_sum_launches)
    with torch.inference_mode():
        out = model(data)
        assert (fused_conv.launches, fused_conv.fwd_sum_launches) == (before[0] + 3, before[1] + 3)
        with fused_conv.force_plain():
            ref = model(data)
    real = data[K.GRAPH_MASK]
    np.testing.assert_allclose(
        out[real].cpu().numpy(), ref[real].cpu().numpy(), rtol=1e-4, atol=1e-4
    )

    # backward through the kernels against the plain path (eval mode: the
    # batch statistics of two forwards would differ only in the last bits)
    def grads():
        model.zero_grad(set_to_none=True)
        model(data)[real].square().sum().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    counters = ("launches", "fwd_sum_launches", "bwd_launches", "dx_sum_launches")
    before = [getattr(fused_conv, c) for c in counters]
    got = grads()
    assert [getattr(fused_conv, c) for c in counters] == [b + 3 for b in before]
    with fused_conv.force_plain():
        ref = grads()
    for n, r in ref.items():
        scale = float(r.abs().max().clamp_min(1e-12))
        np.testing.assert_allclose((got[n] / scale).cpu().numpy(), (r / scale).cpu().numpy(),
                                   atol=1e-4, err_msg=n)


def test_variant_model_through_kernels(dev):
    """The model with every option the port took in late (instance norm,
    norm activation, gaussian basis, max pooling, atom and global features,
    a scalar head), 2 conv layers deep, at the production SH and conv
    irreps: forward and parameter gradients of the weighted two-task loss
    through the kernels against `force_plain()`, 3 launches of each counter,
    on a batch with an all-padding graph; everything finite."""
    from matten_tpu_torch.data.graph import CrystalGraph, PadSpec, collate_graphs
    from matten_tpu_torch.data.structure import Structure
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.predict import batch_to_device

    hp = dict(PRODUCTION, num_layers=2, normalization="instance", nonlinearity_type="norm",
              radial_basis_type="gaussian", reduce="max", use_atom_feats=True, use_global_feats=True,
              tensor_target_name="elastic_tensor_full", scalar_target_names=["k_voigt"])
    ds = dict(allowed_species=list(SPECIES_5), atom_feats_size=2, global_feats_size=1)
    model = create_scalar_tensor_model(hp, ds, device=dev).eval()
    rng = np.random.default_rng(5)
    graphs = []
    for _ in range(3):
        s = Structure(lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1,
                      frac_coords=rng.uniform(0, 1, size=(5, 3)), atomic_numbers=rng.choice(SPECIES_5, size=5))
        graphs.append(CrystalGraph.from_structure(
            s, r_cut=5.0, x={"atom_feats": rng.normal(size=(5, 2)), "global_feats": rng.normal(size=(1, 1))}))
    n_edges = sum(g.edge_index.shape[1] for g in graphs)
    data, _ = collate_graphs(graphs, PadSpec(24, n_edges + 256, 4), species_map=atomic_number_map(SPECIES_5))
    data = batch_to_device(data, dev)
    real = data[K.GRAPH_MASK]
    counters = ("launches", "fwd_sum_launches", "bwd_launches", "dx_sum_launches")
    before = [getattr(fused_conv, c) for c in counters]
    with torch.inference_mode():
        out = model(data)
        with fused_conv.force_plain():
            ref = model(data)
    assert [getattr(fused_conv, c) for c in counters] == [before[0] + 3, before[1] + 3, before[2], before[3]]
    for k in ("elastic_tensor_full", "k_voigt"):
        assert torch.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k][real].cpu().numpy(), ref[k][real].cpu().numpy(), rtol=1e-4, atol=1e-4)

    def grads():
        model.zero_grad(set_to_none=True)
        o = model(data)
        (o["elastic_tensor_full"][real].square().sum() + 0.5 * o["k_voigt"][real].square().sum()).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    before = [getattr(fused_conv, c) for c in counters]
    got = grads()
    assert [getattr(fused_conv, c) for c in counters] == [b + 3 for b in before]
    with fused_conv.force_plain():
        ref = grads()
    for n, r in ref.items():
        assert torch.isfinite(got[n]).all(), n
        scale = float(r.abs().max().clamp_min(1e-12))
        np.testing.assert_allclose((got[n] / scale).cpu().numpy(), (r / scale).cpu().numpy(),
                                   atol=1e-4, err_msg=n)


def test_kernels_match_plain_and_are_bitwise_deterministic_at_nmr_plans(dev):
    """K1 (item pass and partial-row sum) and the merged backward with its
    dx sum at the 4 plans of the NMR model (SH rows 9 wide, padded to 16;
    4x2o / 4x2e paths) on an NMR-batch-sized random graph, against their
    plain versions, and two runs bitwise equal."""
    plans = _nmr_plans(dev)
    shapes = [(p.irreps_in1.dim, p.weight_numel, p.irreps_out.dim, len(p.instructions)) for p in plans]
    assert shapes == [(16, 48, 144, 3), (100, 216, 696, 15), (168, 336, 1104, 27), (200, 432, 1392, 30)]
    rng = np.random.default_rng(16)
    n, e = 192, 10000
    src, dst = rng.integers(0, n, e), np.sort(rng.integers(0, n - 4, e))
    for i, plan in enumerate(plans):
        t = _inputs_on_graph(dev, 50 + i, plan, n, src, dst)
        args = (plan, t["x"], t["sh"], t["w"], t["src"], t["dst"], n)
        edges = fused_conv.edge_plan(t["src"], t["dst"], n, n, with_src_order=True)
        out = fused_conv.fused_uvu_conv(*args, edges)
        assert torch.equal(out, fused_conv.fused_uvu_conv(*args, edges))
        _assert_rel(out, fused_conv.uvu_conv_reference(*args))
        assert bool((out[n - 4 :] == 0).all())
        g = torch.as_tensor(rng.normal(size=(n, plan.irreps_out.dim)).astype(np.float32), device=dev)
        dx, dw = _check_backward(plan, t, g, n)
        dx2, dw2 = fused_conv.uvu_conv_bwd(plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], n, edges)
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


def _nmr_structures(n=6, seed=8):
    from matten_tpu_torch.data.structure import Structure

    rng = np.random.default_rng(seed)
    return [
        Structure(
            lattice=np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1,
            frac_coords=rng.uniform(0, 1, size=(k, 3)),
            atomic_numbers=rng.choice(SPECIES_5, size=k),
        )
        for k in rng.integers(4, 13, n)
    ]


def test_atomic_model_forward_through_kernels(dev):
    """The NMR model at full width: 4 launches of each of K1's kernels per
    forward, its real rows against the plain path."""
    from matten_tpu_torch.data.graph import CrystalGraph, collate_graphs, pad_spec_for
    from matten_tpu_torch.models import create_atomic_tensor_model
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.predict import batch_to_device

    model = create_atomic_tensor_model(NMR, dict(allowed_species=list(SPECIES_5)), device=dev).eval()
    graphs = [CrystalGraph.from_structure(s, r_cut=5.0) for s in _nmr_structures()]
    data, _ = collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(SPECIES_5))
    data = batch_to_device(data, dev)
    before = (fused_conv.launches, fused_conv.fwd_sum_launches)
    with torch.inference_mode():
        out = model(data)
        assert (fused_conv.launches, fused_conv.fwd_sum_launches) == (before[0] + 4, before[1] + 4)
        with fused_conv.force_plain():
            ref = model(data)
    real = data[K.NODE_MASK]
    assert out.shape == (real.shape[0], 6) and bool(torch.isfinite(out).all())
    _assert_rel(out[real], ref[real], 1e-4)


def test_predict_from_checkpoint_dir_on_the_card(dev, tmp_path):
    """`predict(structures, directory)` of both families on the card equals
    the in-memory `predict` of the same weights and launches K1."""
    from matten_tpu_torch.data.dataset import DatasetStatistics
    from matten_tpu_torch.data.transform import MeanNormNormalize
    from matten_tpu_torch.models import create_atomic_tensor_model, create_scalar_tensor_model
    from matten_tpu_torch.ops.cartesian import cartesian_tensor_map
    from matten_tpu_torch.predict import predict
    from matten_tpu_torch.train import CheckpointManager, save_sidecar

    structures = _nmr_structures(seed=9)
    ds = dict(allowed_species=list(SPECIES_5), average_num_neighbors=30.0)
    rng = np.random.default_rng(10)
    for name, hp, create, data_hp in (
            ("elastic", PRODUCTION, create_scalar_tensor_model, {"tensor_target_name": "elastic_tensor_full"}),
            ("nmr", NMR, create_atomic_tensor_model,
             {"tensor_target_name": "nmr_tensor", "tensor_target_formula": "ij=ji",
              "atom_selector": "atom_selector"})):
        irreps = cartesian_tensor_map(hp["output_formula"]).irreps
        norm = MeanNormNormalize(irreps, mean=rng.normal(size=irreps.dim), norm=rng.uniform(0.5, 2, irreps.dim))
        model = create(hp, ds, device=dev, seed=3)
        save_sidecar(tmp_path / name, {"model": hp, "data": dict(data_hp, r_cut=5.0), "dataset_hparams": ds,
                                       "normalize_tensor_target": True},
                     DatasetStatistics(tuple(SPECIES_5), 30.0, norm).to_arrays())
        CheckpointManager(tmp_path / name).save(0, {"model": model.state_dict()}, {"val/score": 1.0})
        mem = predict(structures, model, norm)
        before = (fused_conv.launches, fused_conv.fwd_sum_launches)
        disk = predict(structures, tmp_path / name)
        assert fused_conv.launches > before[0] and fused_conv.fwd_sum_launches > before[1]
        for a, b, s in zip(mem, disk, structures):
            assert b.shape == ((len(s), 3, 3) if name == "nmr" else (3, 3, 3, 3))
            _assert_rel(torch.as_tensor(np.asarray(b)), torch.as_tensor(np.asarray(a)), 1e-6)


def _fit_setup(dev, num_layers=2):
    """A 16-crystal elasticity data module (10 train crystals in 3 batches
    of at most 4, shuffled each epoch; 6 val crystals in 2), its task and
    the production model at `num_layers`."""
    from matten_tpu_torch.data.datamodule import BatchLoader
    from matten_tpu_torch.data.graph import CrystalGraph
    from matten_tpu_torch.data.transform import MeanNormNormalize
    from matten_tpu_torch.models import create_scalar_tensor_model
    from matten_tpu_torch.nn.embedding import atomic_number_map
    from matten_tpu_torch.ops.cartesian import cartesian_tensor_map
    from matten_tpu_torch.train import CanonicalRegressionTask

    rng = np.random.default_rng(21)
    graphs = []
    for s in _nmr_structures(n=16, seed=20):
        g = CrystalGraph.from_structure(s, r_cut=5.0)
        g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
        graphs.append(g)
    smap = atomic_number_map(SPECIES_5)

    class DataModule:
        def train_dataloader(self):
            return BatchLoader(graphs[:10], batch_size=4, species_map=smap, shuffle=True)

        def val_dataloader(self):
            return BatchLoader(graphs[10:], batch_size=4, species_map=smap)

    irreps = cartesian_tensor_map("ijkl=jikl=klij").irreps
    task = CanonicalRegressionTask(name="elastic_tensor_full", normalizer=MeanNormNormalize(
        irreps, mean=rng.normal(size=21), norm=rng.uniform(0.5, 2.0, 21)))
    hp = dict(PRODUCTION, num_layers=num_layers)
    model = create_scalar_tensor_model(hp, dict(allowed_species=list(SPECIES_5), average_num_neighbors=30.0),
                                       device=dev)
    return DataModule(), task, model


def test_fit_launch_counts_and_host_syncs(dev):
    """A 2-epoch `fit` on the card, after a warm-up epoch that runs each
    batch shape's train and eval step eagerly (building the kernels and
    copying their tables): one launch of each of K1's kernels per conv
    layer in every train step and val batch, and of the merged backward
    and the dx sum in every train step. Under `set_sync_debug_mode("warn")`
    the loop's host syncs are two per epoch, the val sums and the mean
    train loss, each read back once, and one for each first sight of a
    batch shape (shuffled, a shape may first come in a later epoch), whose
    eager step reads back `edge_plan`'s check. The second sight captures
    the step; the `torch.cuda.synchronize` that `torch.cuda.graph` makes
    before a capture is not reported by the debug mode. A replay waits on
    nothing."""
    import dataclasses
    import warnings

    from matten_tpu_torch.train import Trainer, TrainerConfig

    dm, task, model = _fit_setup(dev)
    trainer = Trainer(model, [task], TrainerConfig(max_epochs=1, lr=0.01), device=dev)
    trainer.fit(dm)
    torch.cuda.synchronize()
    seen, graphs = set(trainer._graphs.seen), dict(trainer._graphs.graphs)
    trainer.config = dataclasses.replace(trainer.config, max_epochs=2)
    counters = ("launches", "fwd_sum_launches", "bwd_launches", "dx_sum_launches")
    before = [getattr(fused_conv, c) for c in counters]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            history = trainer.fit(dm)[1:]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    steps, val, convs = 2 * 3, 2 * 2, 3
    assert [getattr(fused_conv, c) - b for c, b in zip(counters, before)] == [
        convs * (steps + val)] * 2 + [convs * steps] * 2
    first_sights = len(trainer._graphs.seen - seen)
    captures = sum(graphs.get(k) is not g for k, g in trainer._graphs.graphs.items())
    assert {k[0] for k in trainer._graphs.graphs} == {"train", "eval"} and captures >= 1
    # the debug mode's notice that it is a prototype comes once per process
    syncs = [str(w.message) for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 2 * 2 + first_sights, (first_sights, captures, syncs)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h[k]) for h in history for k in ("train/loss", "val/loss", "val/score"))


def test_graphed_steps_match_eager_through_shapes_lr_and_restore(dev, tmp_path):
    """A graphed trainer and an eager one (its step graphs dropped, as on
    the CPU; the same capturable Adam) from the same weights, step for step through two pad
    shapes, an lr change (the train graphs captured anew) and
    `restore_last` (the optimizer's state replaced: captured anew): every
    loss and metric sum within 1e-5 relative, the parameters and Adam
    moments at the end within 1e-4 of their largest entry; the eval step
    graphed against eager; replays without a host sync and with exact
    launches; a failed capture raises."""
    import copy

    from matten_tpu_torch.predict import batch_to_device
    from matten_tpu_torch.train import Trainer, TrainerConfig

    dm, task, model = _fit_setup(dev)
    cfg = TrainerConfig(lr=0.01, checkpoint_dir=str(tmp_path / "ck"))
    g = Trainer(model, [task], cfg, device=dev)
    e = Trainer(copy.deepcopy(model), [task], cfg, device=dev)
    e._graphs = None
    assert g._graphs is not None
    assert g.optimizer.defaults["capturable"] and e.optimizer.defaults["capturable"]
    batches = [batch_to_device(d, dev, t) for d, t in dm.train_dataloader()]
    a, b = batches[0], next(x for x in batches if x[0][K.NODE_MASK].shape != batches[0][0][K.NODE_MASK].shape)

    def both(kind, batch, replay):
        before = {c: getattr(fused_conv, c) for c in ("launches", "bwd_launches")}
        if replay:
            torch.cuda.set_sync_debug_mode("error")
        try:
            lg, mg = getattr(g, kind)(*batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launched = {c: getattr(fused_conv, c) - v for c, v in before.items()}
        assert launched == {"launches": 3, "bwd_launches": 3 if kind == "train_step" else 0}, launched
        le, me = getattr(e, kind)(*batch)
        for x, y in [(lg, le)] + [(mg[task.name][j], me[task.name][j]) for j in range(2)]:
            assert abs(float(x) - float(y)) <= 1e-5 * abs(float(y)), (kind, float(x), float(y))

    # eager, capture, replay of a; of b; a replay of a between
    for batch, replay in ((a, 0), (a, 0), (a, 1), (b, 0), (b, 0), (a, 1), (b, 1)):
        both("train_step", batch, replay)
    assert len(g._graphs.graphs) == 2
    g.set_lr(0.005)
    e.set_lr(0.005)
    assert not g._graphs.graphs
    for batch, replay in ((a, 0), (a, 1), (b, 0), (b, 1)):
        both("train_step", batch, replay)
    g._ckpt_manager.save_last(g.state_dict())
    for batch in (a, b):
        both("train_step", batch, 1)
    g.restore_last()
    e.load_state_dict(g._manager().restore(last=True, device=dev))
    assert not g._graphs.graphs
    for batch, replay in ((b, 0), (b, 1), (a, 0), (a, 1)):
        both("train_step", batch, replay)
    for replay in (0, 0, 1):
        both("eval_step", a, replay)
    for (n, p), q in zip(g.model.named_parameters(), e.model.parameters()):
        _assert_rel(p, q, 1e-4)
        for k in ("exp_avg", "exp_avg_sq"):
            _assert_rel(g.optimizer.state[p][k], e.optimizer.state[q][k], 1e-4)
    # a step that cannot be captured (a host read inside it) raises
    g._graphs.steps["train"] = lambda d, t: (d[K.NODE_MASK].sum().item(), {})
    g._graphs.drop("train")
    with pytest.raises(RuntimeError):
        g.train_step(*a)


# a replay of a batch whose dst is out of order, in a process of its own: a
# device-side assert leaves the CUDA context unusable
_BAD_REPLAY = """
import os, sys
import torch
sys.path.insert(0, sys.argv[1])
from test_torch_gpu import _fit_setup
from matten_tpu_torch.data import keys as K
from matten_tpu_torch.predict import batch_to_device
from matten_tpu_torch.train import Trainer, TrainerConfig

dev = torch.device("cuda", 0)
dm, task, model = _fit_setup(dev, num_layers=1)
t = Trainer(model, [task], TrainerConfig(lr=0.01), device=dev)
data, targets = next(iter(dm.train_dataloader()))
data, targets = batch_to_device(data, dev, targets)
for _ in range(3):  # eager, capture, replay
    float(t.train_step(data, targets)[0])
assert len(t._graphs.graphs) == 1
edges = data[K.EDGE_INDEX].clone()
edges[1, 0] = data[K.NODE_MASK].shape[0] - 1  # in range, but the first edge's dst now tops the rest
print("replayed", flush=True)
try:
    t.train_step(dict(data, **{K.EDGE_INDEX: edges}), targets)
    torch.cuda.synchronize()
except RuntimeError as err:
    print("raised:", err, flush=True)
    os._exit(3)
os._exit(0)
"""


def test_bad_batch_on_a_replay_stops_the_card(dev):
    """A captured step cannot read `edge_plan`'s index check back: it asserts
    on the device (`torch._assert_async`), so a replay of a batch whose dst
    is out of order (in range, which no gather of the forward would catch)
    raises at the next sync instead of running K1 on it."""
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests.parent)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", _BAD_REPLAY, str(tests)], capture_output=True, text=True,
                       timeout=600, cwd=tests.parent, env=env)
    assert r.returncode == 3 and "replayed" in r.stdout and "device-side assert" in r.stdout, (
        r.returncode, r.stdout[-2000:], r.stderr[-4000:])


def test_k1_on_its_static_bound_is_bitwise_the_counted_grid(dev):
    """K1's grid is a bound on its items, never below their count; launched
    on the bound it gives the partial rows and the output of a launch on
    the counted grid bitwise, at each item size."""
    plan, t = _inputs(dev, 15, 300, 300, 5000)
    dims = fused_conv._smem_dims(plan)
    for te in (16, 8, 4):
        limit = None if te == 16 else fused_conv.fwd_smem(*dims, 4, te, True)
        with fused_conv.smem_limit(limit):
            edges = fused_conv.edge_plan(t["src"], t["dst"], 300, 300,
                                         item_edges=fused_conv.item_edges_for((plan,), dev))
            item_ptr, bound = edges.items(te)
            count = int(item_ptr[-1])
            assert count <= bound
            args = (plan, t["x"], t["sh"], t["w"], edges)
            part_b, _ = fused_conv._launch_items(*args)
            part_c, _ = fused_conv._launch_items(*args, n_items=count)
            assert part_b.shape[0] == bound and torch.equal(part_b[:count], part_c)
            assert torch.equal(fused_conv._launch_fwd_sum(part_b, item_ptr, 300),
                               fused_conv._launch_fwd_sum(part_c, item_ptr, 300))


def _sharded_layout(ring):
    """A node-sharded layout (1 x 2) of 12 crystals, as the port's loader
    writes it: each shard's c nodes, its edges with src global (node) or
    grouped by source chunk (ring), padding slots at dst = c - 1."""
    from matten_tpu_torch.data.datamodule import BatchLoader
    from matten_tpu_torch.data.graph import CrystalGraph
    from matten_tpu_torch.data.structure import Structure
    from matten_tpu_torch.nn.embedding import atomic_number_map

    rng = np.random.default_rng(21)
    graphs = []
    for _ in range(12):
        k = int(rng.integers(4, 13))
        graphs.append(CrystalGraph.from_structure(Structure(
            np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1, rng.uniform(0, 1, (k, 3)),
            rng.choice(SPECIES_5, size=k)), r_cut=5.0))
    data, _ = next(iter(BatchLoader(graphs, 12, atomic_number_map(SPECIES_5), num_edge_shards=2,
                                    node_shard=True, ring=ring)))
    return data[K.EDGE_INDEX][0], data[K.EDGE_MASK][0], data[K.POSITIONS].shape[2]


@pytest.mark.parametrize("ring", [False, True], ids=["node", "ring"])
def test_kernels_at_the_node_sharded_plans(dev, ring):
    """K1 and the backward at the production plans on a rank's edges of the
    node layouts: node (n_in = 2c gathered rows, n_out = c) and one ring
    group (rank 1's group of its own chunk, src - c, n_in = n_out = c), padding
    slots at c - 1 included; against plain, and two runs bitwise equal."""
    ei, mask, c = _sharded_layout(ring)
    src, dst = ei[1, 0].astype(np.int64), ei[1, 1]
    if ring:
        cap2 = src.shape[0] // 2
        src, dst, mask = src[cap2:] - c, dst[cap2:], mask[1, cap2:]  # rank 1's group of its own chunk
        n_in = c
    else:
        mask = mask[1]
        n_in = 2 * c
    assert (dst[~mask] == c - 1).all() and (~mask).any()
    for i, plan in enumerate(_production_plans(dev)):
        t = _inputs_on_graph(dev, 40 + i, plan, n_in, src, dst)
        g = torch.randn(c, plan.irreps_out.dim, generator=torch.Generator(device=dev).manual_seed(i), device=dev)
        edges = fused_conv.edge_plan(t["src"], t["dst"], n_in, c, with_src_order=True)
        args = (plan, t["x"], t["sh"], t["w"], t["src"], t["dst"])
        out, out2 = (fused_conv.fused_uvu_conv(*args, c, edges) for _ in range(2))
        assert torch.equal(out, out2)
        _assert_rel(out, fused_conv.uvu_conv_reference(*args, c))
        dx, dw = _check_backward(plan, t, g, n_in)
        dx2, dw2 = fused_conv.uvu_conv_bwd(plan, t["x"], g, t["sh"], t["w"], t["src"], t["dst"], n_in, edges)
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("mode", ["edge", "node_ring"])
def test_two_rank_nccl_step_matches_one_rank(mode):
    """A data 1 x graph 2 step of the production model on the flagship
    batch, one card per rank under nccl (`chip_smoke.mesh_rank` through
    `parallel.launch`), against the 1-rank step on card 0, at chip_smoke's
    tolerances (`check_mesh_steps`: loss and metric 1e-5, gradients 1e-4 of
    their largest entry, parameters 2e-5, the ranks bitwise equal, exact
    launches, each rank's kernels against plain, no host staging)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        pytest.skip(f"needs 2 CUDA devices for a 2-rank nccl world; found {cards}")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    structures, rows = chip_smoke.draw_structures()
    cases = chip_smoke.mesh_cases([(f"{mode} 1x2", 1, 2, mode, "production")], structures, rows, profile_all=False)
    steps, refs, one_ms, world_s = chip_smoke.mesh_steps(cases, 2, "nccl", torch.device("cuda", 0), torch)
    chip_smoke.check_mesh_steps(cases, steps, refs, one_ms, torch.cuda.get_device_name(0), "nccl", world_s)
