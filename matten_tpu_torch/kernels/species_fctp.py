"""The species FCTPs of a conv layer as a per-species weight gather.

A species FCTP (`PointConv`'s sc, lin1 and lin2) is a fully connected
tensor product of the node features with the one-hot of the node's species
(`Sx0e`); every path l x 0e -> l is a linear map of the node's channels
under its species' weights, so for a plan of uvw paths p, weights W_p
[mul_in, S, mul_out] (the plan's flat layout) and c_p = path weight /
sqrt(2l + 1):

    out[n, o_k + w d + i] = sum_{p into k} c_p sum_u x[n, x_p + u d + i] W_p[u, s_n, w]
    dx[n, x_i + u d + i]  = sum_{p from i} c_p sum_w g[n, o_p + w d + i] W_p[u, s_n, w]
    dW_p[u, s, w]         = c_p sum_{n : s_n = s} sum_i x[n, x_p + u d + i] g[n, o_p + w d + i]

Padded nodes (the node mask false) give zero rows and add nothing to dW.
It replaces no TPU kernel: the JAX package computes these products in
plain jnp, by the masked contraction against the one-hot (`apply`, whose
[N, u, S, k] intermediates are all but 1/S products with zero) or by the
gather `apply_onehot2`. `TensorProductPlan.apply_onehot2` is the kernel's
plain twin (`species_fctp_reference`), and autograd of it gives the twin's
dx and dW.

The species plan (`species_plan`, `SpeciesPlan`) is built on the device
once per batch, by the first conv layer of a forward, and read by the
others: the nodes in a stable order by species, padded nodes keyed past
the last species, the CSR offsets of each species' segment [S + 2], and
each segment's tiles of at most TILE nodes [S + 2]. Nothing is read back,
so a step stays capturable as a CUDA graph; the forward's grid is a static
bound on the tiles (`tile_bound`).

`species_fctp` takes CUDA tensors only and launches the hand-written
kernels (`csrc/species_fctp.cu`, built by `_build.py`) or raises; off the
card `PointConv.species_fctp` keeps the plain forms. Products that share
their input (sc and lin1) run in one launch each way. A conv layer's budget: 2 launches forward (sc
with lin1, lin2) and 4 backward (dx and dW of each). Module counters of the
launches, as `fused_conv` keeps them: `fwd_launches`, `bwd_dx_launches`,
`bwd_dw_launches` (a step graph's replay adds its capture's while the
tracer is on). The kernels are float32 in storage, FMAs and sums, with no
atomics: two runs are bitwise equal.

What bounds them on an H100 is bytes: the weight tables once forward and
once backward, dW written, x, the cotangents and the outputs; the design
(tiles of one species, the weights staged once per tile, every path of a
product group in one launch) is in the CUDA source.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from matten_tpu_torch.kernels.fused_conv import src_order
from matten_tpu_torch.ops.clebsch_gordan import wigner_3j
from matten_tpu_torch.ops.tensor_product import TensorProductPlan

__all__ = [
    "SpeciesPlan",
    "species_plan",
    "tile_bound",
    "species_fctp",
    "species_fctp_reference",
]

# kernel launches in this process: the forward, dx and dW kernels; each is
# added to right where its kernel launches, and, while the tracer is on, by
# the replay of a captured step (train/graphs.py) what its capture launched
fwd_launches = 0
bwd_dx_launches = 0
bwd_dw_launches = 0

# csrc/species_fctp.cu: SF_TILE nodes per tile, SF_CH channels per task
# and per staged chunk; the launches pass both and the kernels check them
TILE = 16
CH = 32


class SpeciesPlan(NamedTuple):
    """A batch's nodes as the species FCTP kernels walk them."""

    n_species: int
    key: torch.Tensor  # [N] int32: the species index clipped to [0, S - 1], S for a padded node
    perm: torch.Tensor  # [N] int32 nodes in stable key order
    seg_ptr: torch.Tensor  # [S + 2] int32 offsets of each key's nodes in perm (key S: the padded ones)
    tile_ptr: torch.Tensor  # [S + 2] int32 offsets of each key's tiles of at most TILE nodes


def species_plan(species: torch.Tensor, n_species: int, mask: Optional[torch.Tensor] = None) -> SpeciesPlan:
    """Group a batch's nodes by species, on the device (a stable sort and a
    searchsorted, as `fused_conv.src_order`; no host read): `species` [N],
    clipped to [0, n_species - 1] as the one-hot embedding clips it, and
    `mask` [N] (None: every node real), whose false rows are keyed
    n_species."""
    if species.dim() != 1 or (mask is not None and tuple(mask.shape) != tuple(species.shape)):
        raise ValueError(f"species_plan: species {tuple(species.shape)} and mask "
                         f"{None if mask is None else tuple(mask.shape)} must be [N]")
    if n_species < 1:
        raise ValueError(f"species_plan: n_species={n_species}")
    key = species.clamp(0, n_species - 1).to(torch.int32)
    if mask is not None:
        key = torch.where(mask.bool(), key, torch.full_like(key, n_species))
    order = src_order(key, n_species + 1)
    cnt = order.row_ptr[1:] - order.row_ptr[:-1]
    tiles = torch.div(cnt + TILE - 1, TILE, rounding_mode="floor")
    tile_ptr = torch.cat([cnt.new_zeros(1), torch.cumsum(tiles, 0, dtype=torch.int32)])
    return SpeciesPlan(n_species, key, order.perm, order.row_ptr, tile_ptr)


def tile_bound(n: int, n_species: int) -> int:
    """The most tiles n nodes in n_species + 1 segments make: sum_s
    ceil(cnt_s / TILE) <= (n + (S + 1)(TILE - 1)) / TILE, and no more tiles
    than nodes. The forward's and dx's grid; blocks past the real count
    exit."""
    return min(n, (n + (n_species + 1) * (TILE - 1)) // TILE)


class _Path(NamedTuple):
    i_in: int
    i_out: int
    x_off: int  # where the path's input irrep starts in a row of x
    mul_in: int
    o_off: int  # where its output irrep starts in a row of the output
    mul_out: int
    d: int  # 2l + 1
    w_off: int  # where its [mul_in, S, mul_out] block starts in the flat weights
    coef: float  # path weight / sqrt(2l + 1)


@functools.lru_cache(maxsize=None)
def _paths(plan: TensorProductPlan) -> Tuple[_Path, ...]:
    if not plan.in2_is_onehot_compatible:
        raise ValueError(f"species FCTP: {plan} is not one-hot compatible")
    in_sl, out_sl = plan.irreps_in1.slices(), plan.irreps_out.slices()
    out, w_off = [], 0
    for ins, pw, shape in zip(plan.instructions, plan.path_weights, plan.weight_shapes):
        mul_in, ir = plan.irreps_in1[ins.i_in1]
        mul_out = plan.irreps_out[ins.i_out].mul
        c0 = float(wigner_3j(ir.l, 0, ir.l)[0, 0, 0])  # 1/sqrt(2l+1), as apply_onehot2 takes it
        out.append(_Path(ins.i_in1, ins.i_out, in_sl[ins.i_in1].start, mul_in, out_sl[ins.i_out].start,
                         mul_out, ir.dim, w_off, pw * c0))
        w_off += int(np.prod(shape))
    return tuple(out)


def _species(plan: TensorProductPlan) -> int:
    return plan.irreps_in2[0].mul


# ------------------------------------------------------------------ plain twin

def species_fctp_reference(plans: Sequence[TensorProductPlan], x: torch.Tensor,
                           ws: Sequence[torch.Tensor], splan: SpeciesPlan) -> List[torch.Tensor]:
    """The kernels' plain twin: each product as `apply_onehot2` on the
    plan's clipped species, padded rows zeroed; autograd of it gives the
    twin's dx and dW."""
    real = splan.key < splan.n_species
    idx = splan.key.clamp(max=splan.n_species - 1).long()
    return [plan.apply_onehot2(x, idx, w, mask=real) for plan, w in zip(plans, ws)]


# ------------------------------------------------------------------ kernel tables

class LinTables(NamedTuple):
    """A species_linear launch's constant tables (numpy)."""

    tasks: np.ndarray  # [tasks, 8] int32: out id, out offset, d, channels a, term begin, term end, 0, 0
    terms: np.ndarray  # [terms, 8] int32: in id, in offset, k, weight id, weight offset, stride s, a, b
    coefs: np.ndarray  # [terms] float32: c_p
    d_max: int


class DwTables(NamedTuple):
    """A species_dw launch's constant tables (numpy)."""

    # [tasks, 12] int32: g id, x offset, g offset, d, channels u, channels w,
    # weight id, weight offset, stride s, stride u, 0, 0
    tasks: np.ndarray
    coefs: np.ndarray  # [tasks] float32: c_p
    d_max: int


def _check_group(plans: Tuple[TensorProductPlan, ...]) -> None:
    if not 1 <= len(plans) <= 2:
        raise ValueError(f"species FCTP: a launch takes 1 or 2 products, got {len(plans)}")
    for plan in plans:
        _paths(plan)
        if plan.irreps_in1 != plans[0].irreps_in1 or _species(plan) != _species(plans[0]):
            raise ValueError("species FCTP: products launched together share their input irreps and species")


def _lin_tables(tasks, terms, coefs, dims) -> LinTables:
    return LinTables(np.asarray(tasks, dtype=np.int32).reshape(-1, 8),
                     np.asarray(terms, dtype=np.int32).reshape(-1, 8),
                     np.asarray(coefs, dtype=np.float32), max(dims, default=1))


@functools.lru_cache(maxsize=None)
def fwd_tables(plans: Tuple[TensorProductPlan, ...]) -> LinTables:
    """The forward of products sharing x: a task per CH output channels of
    each output irrep of each product (an irrep without paths writes zeros),
    a term per path into it (a = w, b = u)."""
    _check_group(plans)
    s_n = _species(plans[0])
    tasks, terms, coefs = [], [], []
    for q, plan in enumerate(plans):
        paths = _paths(plan)
        for k, ((mul_out, ir), sl) in enumerate(zip(plan.irreps_out, plan.irreps_out.slices())):
            for a0 in range(0, mul_out, CH):
                t0 = len(terms)
                for p in (p for p in paths if p.i_out == k):
                    terms.append((0, p.x_off, p.mul_in, q, p.w_off + a0, p.mul_out, 1, s_n * p.mul_out))
                    coefs.append(p.coef)
                tasks.append((q, sl.start + a0 * ir.dim, ir.dim, min(CH, mul_out - a0), t0, len(terms), 0, 0))
    return _lin_tables(tasks, terms, coefs, [t[2] for t in tasks])


@functools.lru_cache(maxsize=None)
def dx_tables(plans: Tuple[TensorProductPlan, ...]) -> LinTables:
    """dx of products sharing x: a task per CH channels of each input irrep
    (one without paths writes zeros), a term per path from it in every
    product (a = u, b = w; the term's input is that product's cotangent)."""
    _check_group(plans)
    s_n = _species(plans[0])
    tasks, terms, coefs = [], [], []
    for i, ((mul_in, ir), sl) in enumerate(zip(plans[0].irreps_in1, plans[0].irreps_in1.slices())):
        for a0 in range(0, mul_in, CH):
            t0 = len(terms)
            for q, plan in enumerate(plans):
                for p in (p for p in _paths(plan) if p.i_in == i):
                    terms.append((q, p.o_off, p.mul_out, q, p.w_off + a0 * s_n * p.mul_out, p.mul_out,
                                  s_n * p.mul_out, 1))
                    coefs.append(p.coef)
            tasks.append((0, sl.start + a0 * ir.dim, ir.dim, min(CH, mul_in - a0), t0, len(terms), 0, 0))
    return _lin_tables(tasks, terms, coefs, [t[2] for t in tasks])


@functools.lru_cache(maxsize=None)
def dw_tables(plans: Tuple[TensorProductPlan, ...]) -> DwTables:
    """dW of products sharing x: a task per CH x CH weights of each path."""
    _check_group(plans)
    s_n = _species(plans[0])
    tasks, coefs = [], []
    for q, plan in enumerate(plans):
        for p in _paths(plan):
            for u0 in range(0, p.mul_in, CH):
                for w0 in range(0, p.mul_out, CH):
                    tasks.append((q, p.x_off + u0 * p.d, p.o_off + w0 * p.d, p.d, min(CH, p.mul_in - u0),
                                  min(CH, p.mul_out - w0), q, p.w_off + u0 * s_n * p.mul_out + w0, p.mul_out,
                                  s_n * p.mul_out, 0, 0))
                    coefs.append(p.coef)
    return DwTables(np.asarray(tasks, dtype=np.int32).reshape(-1, 12), np.asarray(coefs, dtype=np.float32),
                    max((t[3] for t in tasks), default=1))


@functools.lru_cache(maxsize=None)
def _on(kind: str, plans: Tuple[TensorProductPlan, ...], device: torch.device):
    tab = {"fwd": fwd_tables, "dx": dx_tables, "dw": dw_tables}[kind](plans)
    return tab._replace(**{k: torch.as_tensor(v, device=device) for k, v in tab._asdict().items()
                           if isinstance(v, np.ndarray)})


# ------------------------------------------------------------------ launches

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _pair(ts: Sequence[torch.Tensor]) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    return ts[0], ts[1] if len(ts) > 1 else None


def _width(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.shape[1]


def _linear(kind: str, plans, ins, ws, outs, splan: SpeciesPlan) -> None:
    """The forward ("fwd": ins (x,), outs one per product) or dx ("dx": ins
    one cotangent per product, outs (dx,)) kernel into `outs`."""
    global fwd_launches, bwd_dx_launches
    from matten_tpu_torch.kernels._build import load_library

    n = splan.perm.shape[0]
    grid = tile_bound(n, splan.n_species)
    dev = ins[0].device
    tab = _on(kind, plans, dev)
    (i0, i1), (w0, w1), (o0, o1) = _pair(ins), _pair(ws), _pair(outs)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.species_linear(
            _ptr(i0), _ptr(i1), _width(i0), _width(i1), _ptr(w0), _ptr(w1), _ptr(o0), _ptr(o1),
            _width(o0), _width(o1), splan.perm.data_ptr(), splan.seg_ptr.data_ptr(),
            splan.tile_ptr.data_ptr(), tab.tasks.data_ptr(), tab.terms.data_ptr(), tab.coefs.data_ptr(),
            tab.tasks.shape[0], grid, splan.n_species, tab.d_max, TILE, CH,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"species_fctp {kind}: kernel launch failed (cudaError {rc})")
    if kind == "fwd":
        fwd_launches += 1
    else:
        bwd_dx_launches += 1


def _dw(plans, x, gs, splan: SpeciesPlan) -> List[torch.Tensor]:
    """The dW kernel: one flat gradient per product."""
    global bwd_dw_launches
    from matten_tpu_torch.kernels._build import load_library

    dev = x.device
    tab = _on("dw", plans, dev)
    dws = [torch.empty(p.weight_numel, dtype=torch.float32, device=dev) for p in plans]
    (g0, g1), (d0, d1) = _pair(gs), _pair(dws)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.species_dw(
            x.data_ptr(), x.shape[1], _ptr(g0), _ptr(g1), _width(g0), _width(g1), _ptr(d0), _ptr(d1),
            splan.perm.data_ptr(), splan.seg_ptr.data_ptr(), tab.tasks.data_ptr(), tab.coefs.data_ptr(),
            tab.tasks.shape[0], splan.n_species, tab.d_max, TILE, CH,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"species_fctp dw: kernel launch failed (cudaError {rc})")
    bwd_dw_launches += 1
    return dws


class _SpeciesFctp(torch.autograd.Function):
    """The products sharing x on the card: their outputs, dx and each dW
    from the kernels."""

    @staticmethod
    def forward(ctx, x, splan, plans, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.splan, ctx.plans = splan, plans
        outs = tuple(torch.empty((x.shape[0], p.irreps_out.dim), dtype=torch.float32, device=x.device)
                     for p in plans)
        if x.shape[0]:
            _linear("fwd", plans, (x,), ws, outs, splan)
        return outs

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        plans, splan = ctx.plans, ctx.splan
        gs = tuple(g.contiguous() for g in gs)
        dx, dws = None, [None] * len(ws)
        if ctx.needs_input_grad[0]:
            dx = torch.empty_like(x)
            if x.shape[0]:
                _linear("dx", plans, gs, ws, (dx,), splan)
        if any(ctx.needs_input_grad[3:]):
            dws = _dw(plans, x, gs, splan)
        dws = [d if need else None for d, need in zip(dws, ctx.needs_input_grad[3:])]
        return (dx, None, None, *dws)


def species_fctp(x: torch.Tensor, splan: SpeciesPlan,
                 products: Sequence[Tuple[torch.Tensor, TensorProductPlan]]) -> Tuple[torch.Tensor, ...]:
    """The species FCTPs `products` ((flat weights, one-hot compatible
    plan) pairs, 1 or 2, sharing the input irreps) of x [N, d_in] on the
    nodes of `splan`, on the card: one float32 output [N, d_out] per
    product from one forward launch; its gradient one dx and one dW
    launch. Every tensor is float32 on one CUDA device."""
    plans = tuple(p for _, p in products)
    ws = tuple(w for w, _ in products)
    _check_group(plans)
    n, s_n = x.shape[0], _species(plans[0])
    devices = {t.device for t in (x, *ws, splan.perm, splan.seg_ptr, splan.tile_ptr)}
    if len(devices) > 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"species_fctp: the kernels take CUDA tensors on one device, got {sorted(map(str, devices))}")
    if tuple(x.shape) != (n, plans[0].irreps_in1.dim) or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"species_fctp: x {tuple(x.shape)} {x.dtype} must be contiguous float32 "
                         f"[N, {plans[0].irreps_in1.dim}]")
    if splan.n_species != s_n or splan.perm.shape[0] != n:
        raise ValueError(f"species_fctp: the species plan is for {splan.perm.shape[0]} nodes of "
                         f"{splan.n_species} species, not {n} of {s_n}")
    for w, plan in products:
        if tuple(w.shape) != (plan.weight_numel,) or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError(f"species_fctp: weights {tuple(w.shape)} {w.dtype} must be contiguous float32 "
                             f"[{plan.weight_numel}]")
    return _SpeciesFctp.apply(x, splan, plans, *ws)
