"""The species FCTP kernels' CPU side (`kernels/species_fctp.py`): the
species plan, the plain twin (`apply_onehot2`) and its autograd gradients,
the kernel tables walked as the CUDA kernels walk them, and
`PointConv.species_fctp`'s choice of form on CPU tensors and the "xla" tier.

The twin is checked in float64 against autograd of the masked contraction
`plan.apply(x, one_hot * mask, w) * mask` (1e-10 relative: the same
products, summed in another order), and the tables' walk against the twin.
The kernels themselves run only on the card (`tests/test_torch_gpu.py`).
"""

import numpy as np
import pytest
import torch

from matten_tpu_torch.data import keys as K
from matten_tpu_torch.kernels import fused_tp
from matten_tpu_torch.kernels import species_fctp as sf
from matten_tpu_torch.nn import conv as conv_mod
from matten_tpu_torch.nn.conv import PointConv
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.ops.tensor_product import fully_connected_tp_plan
from matten_tpu_torch.utils import timing

torch.set_num_threads(2)

FEATS = Irreps("37x0e+3x0o+4x1o+2x1e+2x2e+1x3o")  # 37 > CH: two channel chunks
OUT = Irreps("34x0e+2x0e+3x1o+2x2e+1x3o+1x4e")  # two 0e entries; 4e without paths
TOL64 = 1e-10
# the tables hold each path's coefficient in float32, as the kernels read
# it (a relative rounding of 2**-24 per term)
TOL_TABLES = 1e-6


def _batch(s, n, seed, masked, absent=()):
    """Species of n nodes over s species, some absent, and a mask with
    padded rows (their species anything, as a padded batch's are)."""
    rng = np.random.default_rng(seed)
    present = [k for k in range(s) if k not in absent]
    species = rng.choice(present, size=n)
    mask = np.ones(n, dtype=bool)
    if masked:
        mask[rng.choice(n, size=n // 5, replace=False)] = False
        species[~mask] = rng.integers(-3, s + 3, size=int((~mask).sum()))
    return species, mask


@pytest.mark.parametrize("s,masked", [(16, True), (16, False), (73, True), (73, False)])
def test_species_plan_orders_nodes_by_species(s, masked):
    absent = (0, 5, s - 1)
    species, mask = _batch(s, 300, s, masked, absent)
    plan = sf.species_plan(torch.as_tensor(species), s, torch.as_tensor(mask) if masked else None)
    key = np.where(mask, np.clip(species, 0, s - 1), s)
    assert plan.n_species == s
    assert plan.key.dtype == plan.perm.dtype == plan.seg_ptr.dtype == plan.tile_ptr.dtype == torch.int32
    assert np.array_equal(plan.key.numpy(), key)
    assert np.array_equal(plan.perm.numpy(), np.argsort(key, kind="stable"))
    cnt = np.bincount(key, minlength=s + 1)
    assert np.array_equal(plan.seg_ptr.numpy(), np.concatenate([[0], np.cumsum(cnt)]))
    assert all(cnt[k] == 0 for k in absent)
    assert (cnt[s] > 0) == masked
    tiles = -(-cnt // sf.TILE)
    assert np.array_equal(plan.tile_ptr.numpy(), np.concatenate([[0], np.cumsum(tiles)]))
    assert tiles.sum() <= sf.tile_bound(len(key), s) <= len(key)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 300])
@pytest.mark.parametrize("s", [16, 73])
def test_tile_bound_holds_for_every_split(s, n):
    """The bound at its worst: every segment one node past a whole tile."""
    rng = np.random.default_rng(n)
    for _ in range(20):
        cuts = np.sort(rng.integers(0, n + 1, size=s))
        cnt = np.diff(np.concatenate([[0], cuts, [n]]))
        assert (-(-cnt // sf.TILE)).sum() <= sf.tile_bound(n, s)


def _group(s, kind):
    """(plans, x width): sc and lin1 share x; lin2 stands alone."""
    attrs = Irreps(f"{s}x0e")
    if kind == "sc+lin1":
        return (fully_connected_tp_plan(FEATS, attrs, OUT), fully_connected_tp_plan(FEATS, attrs, FEATS))
    return (fully_connected_tp_plan(FEATS, attrs, OUT),)


def _masked_outputs(plans, x, ws, species, mask, s):
    onehot = torch.nn.functional.one_hot(torch.as_tensor(species).clamp(0, s - 1), s).to(x.dtype)
    m = torch.as_tensor(mask)[:, None].to(x.dtype)
    return [plan.apply(x, onehot * m, w) * m for plan, w in zip(plans, ws)]


def _inputs(s, kind):
    """A group's plans, species (absent ones included), mask, and float64
    x, weights and cotangents."""
    plans = _group(s, kind)
    absent = (1, s - 2)
    species, mask = _batch(s, 90, 7 * s, True, absent)
    rng = np.random.default_rng(s)
    x = torch.as_tensor(rng.normal(size=(90, FEATS.dim)))
    ws = [torch.as_tensor(rng.normal(size=p.weight_numel)) for p in plans]
    gs = [torch.as_tensor(rng.normal(size=(90, p.irreps_out.dim))) for p in plans]
    splan = sf.species_plan(torch.as_tensor(species), s, torch.as_tensor(mask))
    return plans, species, mask, absent, x, ws, gs, splan


def _twin(plans, x, ws, gs, splan):
    """The twin's outputs and autograd's (dx, *dW) of them for `gs`."""
    xg, wg = x.clone().requires_grad_(), [w.clone().requires_grad_() for w in ws]
    outs = sf.species_fctp_reference(plans, xg, wg, splan)
    return [o.detach() for o in outs], torch.autograd.grad(outs, [xg, *wg], gs)


def _close(a, b, tol=TOL64):
    a, b = torch.as_tensor(a).detach(), torch.as_tensor(b).detach()
    assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("kind", ["sc+lin1", "lin2"])
@pytest.mark.parametrize("s", [16, 73])
def test_plain_versions_match_the_masked_contraction(s, kind):
    """The twin's forward, and autograd's dx and dW of it, against autograd
    of the masked contraction, float64, with padded rows and absent
    species; dW of an absent species is exactly zero."""
    plans, species, mask, absent, x, ws, gs, splan = _inputs(s, kind)
    xg, wg = x.clone().requires_grad_(), [w.clone().requires_grad_() for w in ws]
    ref = _masked_outputs(plans, xg, wg, species, mask, s)
    grads = torch.autograd.grad(ref, [xg, *wg], gs)
    outs, twin_grads = _twin(plans, x, ws, gs, splan)
    for out, r in zip(outs, ref):
        _close(out, r)
    for g, r in zip(twin_grads, grads):
        _close(g, r)
    for plan, dw in zip(plans, twin_grads[1:]):
        for tab in plan.split_weights(dw):
            assert not tab[:, list(absent)].any()


def _walk_linear(tab, ins, ws, widths, splan):
    """`species_linear_kernel` in numpy: a block per (tile, task), the tile
    found in `tile_ptr`, the padded rows' tiles writing zeros; every output
    entry starts NaN, so one the tables miss shows."""
    s_n, n = splan.n_species, splan.perm.shape[0]
    perm, seg, tptr = (t.numpy() for t in (splan.perm, splan.seg_ptr, splan.tile_ptr))
    outs = [np.full((n, w), np.nan) for w in widths]
    for tile in range(sf.tile_bound(n, s_n)):
        if tile >= tptr[s_n + 1]:
            continue
        s = int(np.searchsorted(tptr, tile, side="right")) - 1
        first = seg[s] + (tile - tptr[s]) * sf.TILE
        rows = perm[first:min(first + sf.TILE, seg[s + 1])]
        for t, (out_id, out_off, d, n_a, t0, t1, _, _) in enumerate(tab.tasks):
            acc = np.zeros((len(rows), n_a, d))
            for k in range(t0, t1) if s < s_n else ():
                in_id, in_off, n_b, w_id, w_off, st_s, st_a, st_b = tab.terms[k]
                xin = ins[in_id][rows, in_off:in_off + n_b * d].reshape(len(rows), n_b, d)
                w = ws[w_id][w_off + s * st_s + np.arange(n_a)[:, None] * st_a + np.arange(n_b)[None, :] * st_b]
                acc += tab.coefs[k] * np.einsum("jbi,ab->jai", xin, w)
            outs[out_id][rows, out_off:out_off + n_a * d] = acc.reshape(len(rows), -1)
    return outs


def _walk_dw(tab, x, gs, sizes, splan):
    """`species_dw_kernel` in numpy: a block per (species, task), summed
    over the species' nodes; padded rows in no species."""
    s_n = splan.n_species
    perm, seg = splan.perm.numpy(), splan.seg_ptr.numpy()
    dws = [np.full(size, np.nan) for size in sizes]
    for s in range(s_n):
        rows = perm[seg[s]:seg[s + 1]]
        for t, (g_id, x_off, g_off, d, n_u, n_w, w_id, w_off, st_s, st_u, _, _) in enumerate(tab.tasks):
            xs = x[rows, x_off:x_off + n_u * d].reshape(len(rows), n_u, d)
            g = gs[g_id][rows, g_off:g_off + n_w * d].reshape(len(rows), n_w, d)
            at = w_off + s * st_s + np.arange(n_u)[:, None] * st_u + np.arange(n_w)[None, :]
            dws[w_id][at] = tab.coefs[t] * np.einsum("jui,jwi->uw", xs, g)
    return dws


@pytest.mark.parametrize("kind", ["sc+lin1", "lin2"])
@pytest.mark.parametrize("s", [16, 73])
def test_kernel_tables_walked_as_the_kernels_give_the_twin(s, kind):
    """The forward, dx and dW tables, walked block by block as the CUDA
    kernels walk them (float64 but for the tables' float32 coefficients),
    write every entry and give the twin's outputs and its autograd
    gradients, with padded rows and absent species."""
    plans, _, mask, absent, x, ws, gs, splan = _inputs(s, kind)
    outs, (dx, *dws) = _twin(plans, x, ws, gs, splan)
    xn, wn, gn = x.numpy(), [w.numpy() for w in ws], [g.numpy() for g in gs]
    walked = _walk_linear(sf.fwd_tables(plans), [xn], wn, [p.irreps_out.dim for p in plans], splan)
    for out, ref in zip(walked, outs):
        _close(out, ref, TOL_TABLES)
        assert not out[~mask].any()
    (walked_dx,) = _walk_linear(sf.dx_tables(plans), gn, wn, [FEATS.dim], splan)
    _close(walked_dx, dx, TOL_TABLES)
    walked_dw = _walk_dw(sf.dw_tables(plans), xn, gn, [p.weight_numel for p in plans], splan)
    for plan, dw, ref in zip(plans, walked_dw, dws):
        _close(dw, ref, TOL_TABLES)
        for tab in plan.split_weights(torch.as_tensor(dw)):
            assert not tab[:, list(absent)].any()


def test_species_fctp_takes_cuda_tensors_only():
    """Off the card the kernels' entry refuses its inputs (PointConv keeps
    the plain forms there)."""
    plans, _, _, _, x, ws, _, splan = _inputs(16, "sc+lin1")
    with pytest.raises(ValueError, match="CUDA"):
        sf.species_fctp(x.float(), splan, [(w.float(), p) for w, p in zip(ws, plans)])


@pytest.mark.parametrize("kind", ["sc+lin1", "lin2"])
def test_kernel_tables_cover_every_output_input_and_weight(kind):
    """The forward's tasks cover every output entry once, dx's every input
    entry once, dW's every weight of every species once."""
    s = 16
    plans = _group(s, kind)
    fwd, dx, dw = sf.fwd_tables(plans), sf.dx_tables(plans), sf.dw_tables(plans)
    seen = [np.zeros(p.irreps_out.dim, dtype=int) for p in plans]
    for q, off, d, n_a, *_ in fwd.tasks:
        seen[q][off:off + n_a * d] += 1
        assert n_a <= sf.CH
    assert all((c == 1).all() for c in seen)
    din = np.zeros(FEATS.dim, dtype=int)
    for _, off, d, n_a, *_ in dx.tasks:
        din[off:off + n_a * d] += 1
    assert (din == 1).all()
    wt = [np.zeros(p.weight_numel, dtype=int) for p in plans]
    for _, _, _, d, n_u, n_w, q, off, st_s, st_u, *_ in dw.tasks:
        for u in range(n_u):
            for k in range(s):
                wt[q][off + u * st_u + k * st_s:off + u * st_u + k * st_s + n_w] += 1
    assert all((c == 1).all() for c in wt)
    # 4e (d = 9) is an output without paths: only the forward writes it
    assert (fwd.d_max, dx.d_max, dw.d_max) == (9, 7, 7)


def _conv_data(s, seed=0, n=12, e=60, species_index=True):
    rng = np.random.default_rng(seed)
    feats, sh = Irreps("6x0e+2x1o"), Irreps("0e+1o+2e")
    mask = np.arange(n) < n - 2
    species = rng.integers(0, s, n)
    onehot = np.eye(s)[species] * mask[:, None]
    f32 = np.float32
    data = {
        K.NODE_FEATURES: rng.normal(size=(n, feats.dim)).astype(f32),
        K.NODE_ATTRS: onehot.astype(f32),
        K.EDGE_ATTRS: rng.normal(size=(e, sh.dim)).astype(f32),
        K.EDGE_EMBEDDING: rng.normal(size=(e, 8)).astype(f32),
        K.EDGE_INDEX: np.stack([rng.integers(0, n - 2, e), np.sort(rng.integers(0, n - 2, e))]).astype(np.int32),
        K.NUM_NEIGH: rng.integers(1, 8, n).astype(f32),
        K.NODE_MASK: mask,
    }
    if species_index:
        data[K.SPECIES_INDEX] = species.astype(np.int32)
    data = {k: torch.as_tensor(v) for k, v in data.items()}
    irreps = {K.NODE_FEATURES: feats, K.NODE_ATTRS: Irreps(f"{s}x0e"), K.EDGE_ATTRS: sh,
              K.EDGE_EMBEDDING: Irreps("8x0e")}
    conv = PointConv(irreps, Irreps("4x0e+2x1o+1x2e"), torch.Generator().manual_seed(seed),
                     avg_num_neighbors=4.0)
    return conv, data


# (species, tier, MATTEN_ONEHOT_GATHER_MIN_S, SPECIES_INDEX in the batch, today's form)
SELECTION = {
    "S73": (73, "pallas", None, True, "masked"),
    "S73-xla": (73, "xla", None, True, "masked"),
    "S73-gather": (73, "pallas", "16", True, "gather"),
    "S73-xla-gather": (73, "xla", "16", True, "gather"),
    "S73-no-index": (73, "pallas", "16", False, "masked"),
    "S16": (16, "pallas", None, True, "masked"),
    "S5": (5, "pallas", None, True, "plain"),
    "S5-gather": (5, "pallas", "4", True, "gather"),
}


@pytest.mark.parametrize("case", sorted(SELECTION))
def test_species_fctp_keeps_todays_forms_off_the_card(case, monkeypatch):
    """CPU tensors, either tier: each layer's species FCTPs take today's
    form (the kernels are never called), equal to it bit for bit, and the
    tracer (without marks) counts every product as "fctp.plain"."""
    s, impl, gather, index, form = SELECTION[case]
    if gather is None:
        monkeypatch.delenv("MATTEN_ONEHOT_GATHER_MIN_S", raising=False)
    else:
        monkeypatch.setenv("MATTEN_ONEHOT_GATHER_MIN_S", gather)

    def refused(*args, **kwargs):
        raise AssertionError("the species FCTP kernels were taken off the card")

    monkeypatch.setattr(conv_mod, "species_fctp", refused)
    monkeypatch.setattr(conv_mod, "species_plan", refused)
    conv, data = _conv_data(s, species_index=index)
    x, mask, attrs = data[K.NODE_FEATURES], data[K.NODE_MASK], data[K.NODE_ATTRS]
    products = [(conv.w_sc, conv.sc_plan), (conv.w_lin1, conv.lin1_plan)]
    prev = fused_tp.get_tp_impl()
    fused_tp.set_tp_impl(impl)
    try:
        with timing.tracing(marks=False):
            timing.clear()
            outs = conv.species_fctp(dict(data))(x, *products)
            conv(data)
            counters = timing.record().counters
    finally:
        fused_tp.set_tp_impl(prev)
        timing.clear()
    for out, (w, plan) in zip(outs, products):
        if form == "gather":
            want = plan.apply_onehot2(x, data[K.SPECIES_INDEX].long().clamp(0, s - 1), w, mask=mask)
        else:
            want = plan.apply(x, attrs, w)
            want = want * mask[:, None].float() if form == "masked" else want
        assert torch.equal(out, want)
    assert counters.get("fctp.plain") == 2 + 3 and "fctp.kernel" not in counters
