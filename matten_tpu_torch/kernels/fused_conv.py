"""Fused uvu tensor-product convolution: K1 forward and its merged backward.

Counterpart of `matten_tpu/kernels/fused_conv.py`. The forward (K1, the
counterpart of `_build_fwd2`, dispatched by `fused_uvu_conv_t`) computes

    out[n] = sum_{e : dst[e] = n} TP_uvu(x[src[e]], sh[e], w[e])

without storing the [E, dout] messages. Its gradient (`uvu_conv_bwd`) is
two kernels, the counterparts of the merged backward `_build_bwd2` (K2) and
of the chunked pair the JAX package takes beyond 2048 nodes, the transposed
`_build_call` (K3) for dx and `_build_dw_call` (K4) for dw:

    dw[e, k]  = d out[dst[e]] / d w[e, k]  contracted with g[dst[e]]
    dxe[e]    = TP_uvu^T(g[dst[e]], sh[e], w[e])       (one pass over edge tiles)
    dx[n]     = sum_{e : src[e] = n} dxe[e]              (a segment sum)

On CUDA tensors each wrapper launches its hand-written kernels
(`csrc/fused_conv.cu`, `csrc/fused_conv_bwd.cu`, built by `_build.py`) or
raises; on CPU tensors it runs the kernels' plain version
(`uvu_conv_reference`, `uvu_conv_bwd_reference`). The gradient with
respect to sh comes from autograd of the plain forward, and only when sh
requires it, as in the JAX backward. The TPU machinery of the JAX kernels
(transposed [D, E] layout, one-hot-matmul gathers and scatters, node-chunk
owner maps, VMEM budgets, m-major rows) has no counterpart here: edges
arrive sorted by destination, the forward walks each destination's CSR
segment, the backward walks tiles of consecutive edges, and its dx rows are
summed over a stable src-sorted permutation of the edges.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from matten_tpu_torch.ops.scatter import scatter_sum
from matten_tpu_torch.ops.tensor_product import TensorProductPlan
from matten_tpu_torch.ops.wigner import wigner_3j

__all__ = [
    "fused_uvu_conv",
    "uvu_conv_bwd",
    "uvu_conv_reference",
    "uvu_conv_bwd_reference",
    "SrcOrder",
    "src_order",
    "force_plain",
]

# kernel launches in this process: K1 (`launches`), the merged backward and
# the dx segment sum; each wrapper adds one per launch of its kernel and
# nothing else touches them except a caller resetting them
launches = 0
bwd_launches = 0
dx_reduce_launches = 0

# the merged backward's launch shape (csrc/fused_conv_bwd.cu: BWD_TE,
# BWD_WARPS); its task table is built for it and the launch checks both
BWD_TILE_EDGES = 16
BWD_WARPS = 24
# irreps the merged backward takes: l <= 4 (d1, d3 <= 9), the production range
BWD_MAX_D = 9

_force_plain = False


@contextlib.contextmanager
def force_plain():
    """Test hook: run the conv through its plain version on CUDA tensors too,
    so a caller can compare the kernel path with the plain path."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def uvu_conv_reference(
    plan: TensorProductPlan,
    x: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_out: int,
) -> torch.Tensor:
    """Plain version: materialize the [E, dout] messages, then segment-sum
    (counterpart of `_reference` in the JAX kernel module)."""
    msg = plan.apply(x[src.long()], sh, w)
    return scatter_sum(msg, dst, n_out)


def uvu_conv_dxe_reference(
    plan: TensorProductPlan,
    g: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the per-edge dx rows [E, d1]: the messages are
    linear in x[src], so the per-edge cotangent g[dst] goes back through
    `plan.apply` by autograd."""
    with torch.enable_grad():
        xe = sh.new_zeros((sh.shape[0], plan.irreps_in1.dim), requires_grad=True)
        msg = plan.apply(xe, sh.detach(), w.detach())
        (dxe,) = torch.autograd.grad(msg, xe, g[dst.long()])
    return dxe


def uvu_conv_dx_reference(
    plan: TensorProductPlan,
    g: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_in: int,
) -> torch.Tensor:
    """Plain version of dx [n_in, d1]: the per-edge rows segment-summed into src."""
    return scatter_sum(uvu_conv_dxe_reference(plan, g, sh, w, dst), src, n_in)


def uvu_conv_dw_reference(
    plan: TensorProductPlan,
    x: torch.Tensor,
    g: torch.Tensor,
    sh: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """Plain version of dw [E, dw]: the messages are linear in w[e], so the
    per-edge cotangent g[dst] goes back through `plan.apply` by autograd."""
    with torch.enable_grad():
        we = sh.new_zeros((sh.shape[0], plan.weight_numel), requires_grad=True)
        msg = plan.apply(x.detach()[src.long()], sh.detach(), we)
        (dw,) = torch.autograd.grad(msg, we, g[dst.long()])
    return dw


def uvu_conv_bwd_reference(
    plan: TensorProductPlan,
    x: torch.Tensor,
    g: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_in: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the merged backward: (dx [n_in, d1], dw [E, dw])."""
    return (
        uvu_conv_dx_reference(plan, g, sh, w, src, dst, n_in),
        uvu_conv_dw_reference(plan, x, g, sh, src, dst),
    )


class KernelTables(NamedTuple):
    """Per-plan constant tables of the kernel (numpy)."""

    t_meta: np.ndarray  # [n_t, 4] int32: cg offset, sh offset, d2, 0
    cg: np.ndarray  # [sum d2] float32: C[m1, :, m3] of every CG block entry
    out_meta: np.ndarray  # [dout, 4] int32: x idx, t idx, w idx, d1 | d3 << 16
    out_pw: np.ndarray  # [dout] float32: path weight of each component


@functools.lru_cache(maxsize=None)
def kernel_tables(plan: TensorProductPlan) -> KernelTables:
    """Path metadata of a uvu plan in the kernel's form.

    Every output component o belongs to one path p and channel u: its
    message reads x[src, x_off_p + u * d1 + m1], w[e, w_off_p + u] and the
    CG block of (l1, sh entry, l3) contracted with sh. Blocks are shared by
    every path with the same (l1, sh entry, l3)."""
    if not all(ins.mode == "uvu" and ins.has_weight for ins in plan.instructions):
        raise ValueError("the fused conv takes weighted uvu plans only")
    if any(mul != 1 for mul, _ in plan.irreps_in2):
        raise ValueError(f"the fused conv needs multiplicity-1 irreps_in2, got {plan.irreps_in2}")
    if sorted(ins.i_out for ins in plan.instructions) != list(range(len(plan.irreps_out))):
        raise ValueError("the fused conv needs exactly one path per output entry")

    in1_sl = plan.irreps_in1.slices()
    in2_sl = plan.irreps_in2.slices()
    out_sl = plan.irreps_out.slices()
    dout = plan.irreps_out.dim
    t_meta, cg = [], []
    blocks: Dict[Tuple[int, int, int], int] = {}
    out_meta = np.zeros((dout, 4), dtype=np.int32)
    out_pw = np.zeros(dout, dtype=np.float32)
    w_off = 0
    for ins, pw, wshape in zip(plan.instructions, plan.path_weights, plan.weight_shapes):
        mul1, ir1 = plan.irreps_in1[ins.i_in1]
        ir2 = plan.irreps_in2[ins.i_in2].ir
        ir3 = plan.irreps_out[ins.i_out].ir
        d1, d2, d3 = ir1.dim, ir2.dim, ir3.dim
        key = (ir1.l, ins.i_in2, ir3.l)
        if key not in blocks:
            blocks[key] = len(t_meta)
            c = wigner_3j(ir1.l, ir2.l, ir3.l)
            for m1 in range(d1):
                for m3 in range(d3):
                    t_meta.append((len(cg), in2_sl[ins.i_in2].start, d2, 0))
                    cg.extend(c[m1, :, m3])
        t_off = blocks[key]
        x_off, o_off = in1_sl[ins.i_in1].start, out_sl[ins.i_out].start
        for u in range(mul1):
            for m3 in range(d3):
                o = o_off + u * d3 + m3
                out_meta[o] = (x_off + u * d1, t_off + m3, w_off + u, d1 | (d3 << 16))
                out_pw[o] = pw
        w_off += int(np.prod(wshape))
    return KernelTables(
        np.asarray(t_meta, dtype=np.int32).reshape(-1, 4),
        np.asarray(cg, dtype=np.float32),
        out_meta,
        out_pw,
    )


class BackwardTables(NamedTuple):
    """Per-plan constant tables of the merged backward kernel (numpy),
    derived from the forward's `KernelTables`."""

    cg_t: np.ndarray  # [BWD_MAX_D, n_t] float32: C_i[m2] at [m2, i], 0 past d2_i
    t_sh: np.ndarray  # [n_t] int32: where entry i's sh irrep starts in a padded sh row
    sh_src: np.ndarray  # [padded sh row] int32: sh component of each slot, -1 for padding
    groups: np.ndarray  # [irreps of in1, 4] int32: x_off, d1, path begin, path end
    paths: np.ndarray  # [paths, 4] int32: o_off, t_off, w_off, d3
    path_pw: np.ndarray  # [paths] float32
    tasks: np.ndarray  # [tasks, 4] int32: u0 | nu << 16, group, u count, j0 | ne << 16
    warp_ptr: np.ndarray  # [BWD_WARPS + 1] int32: each warp's tasks


@functools.lru_cache(maxsize=None)
def backward_tables(plan: TensorProductPlan) -> BackwardTables:
    """Tables of the merged backward kernel.

    A lane of the kernel owns one input channel (irrep i, u) of one edge
    and every weight k = (path p of i, u) that reads it. Channel u of irrep
    i reads x at x_off(i) + u d1, and path p's weight k = w_off(p) + u, its
    output components o_off(p) + u d3 + m3 and the CG block entries t_off(p)
    + m1 d3 + m3: so `groups` and `paths` hold every channel's entries up to
    the stride in u. Offsets come from the forward's `out_meta` at the first
    component of each path (u = 0, m3 = 0).

    The lanes of one warp task hold nu consecutive channels u of one irrep
    (nu = min(mul, 32)) and 32 // nu consecutive edges of the tile. The
    tasks of a tile are dealt to the block's warps heaviest first, each to
    the warp with the least work so far (work: the lane's multiply-adds)."""
    tab = kernel_tables(plan)
    big = [ir for irreps in (plan.irreps_in1, plan.irreps_in2, plan.irreps_out)
           for _, ir in irreps if ir.dim > BWD_MAX_D]
    if big:
        raise ValueError(f"the conv backward kernel takes irreps up to l=4, got {big}")
    n_t = tab.t_meta.shape[0]
    cg_t = np.zeros((BWD_MAX_D, n_t), dtype=np.float32)
    for i, (cg_off, _, d2, _) in enumerate(tab.t_meta):
        cg_t[:d2, i] = tab.cg[cg_off : cg_off + d2]
    # each sh irrep padded to a multiple of 4 floats, for 16-byte reads
    sh_src, pad_at = [], {}
    for sl in plan.irreps_in2.slices():
        pad_at[sl.start] = len(sh_src)
        n = sl.stop - sl.start
        sh_src += list(range(sl.start, sl.stop)) + [-1] * (-n % 4)
    t_sh = np.asarray([pad_at[int(off)] for off in tab.t_meta[:, 1]], dtype=np.int32)

    out_sl = plan.irreps_out.slices()
    by_irrep = [[] for _ in plan.irreps_in1]
    for ins in plan.instructions:
        o = out_sl[ins.i_out].start
        _, t_idx, w_idx, dims = (int(v) for v in tab.out_meta[o])
        by_irrep[ins.i_in1].append((o, t_idx, w_idx, dims >> 16, float(tab.out_pw[o])))
    groups, paths, path_pw, cost = [], [], [], []
    x_sl = plan.irreps_in1.slices()
    for i, (_, ir) in enumerate(plan.irreps_in1):
        d1 = ir.dim
        groups.append((x_sl[i].start, d1, len(paths), len(paths) + len(by_irrep[i])))
        paths += [p[:4] for p in by_irrep[i]]
        path_pw += [p[4] for p in by_irrep[i]]
        cost.append(sum(d1 * d3 + d3 + 2 * d1 for _, _, _, d3, _ in by_irrep[i]))

    te = BWD_TILE_EDGES
    tasks = []  # (cost, task)
    for gi, (mul, _) in enumerate(plan.irreps_in1):
        if not mul:
            continue
        # an irrep without paths still gets tasks: they write its dx rows as zeros
        nu = min(mul, 32)
        ne = min(32 // nu, te)
        for u0 in range(0, mul, nu):
            for j0 in range(0, te, ne):
                task = (u0 | nu << 16, gi, min(nu, mul - u0), j0 | min(ne, te - j0) << 16)
                tasks.append((cost[gi], task))
    load = [0] * BWD_WARPS
    per_warp = [[] for _ in range(BWD_WARPS)]
    for c, task in sorted(tasks, key=lambda ct: -ct[0]):
        wi = int(np.argmin(load))
        load[wi] += c
        per_warp[wi].append(task)
    warp_ptr = np.cumsum([0] + [len(t) for t in per_warp]).astype(np.int32)
    return BackwardTables(
        cg_t,
        t_sh,
        np.asarray(sh_src, dtype=np.int32),
        np.asarray(groups, dtype=np.int32).reshape(-1, 4),
        np.asarray(paths, dtype=np.int32).reshape(-1, 4),
        np.asarray(path_pw, dtype=np.float32),
        np.asarray([t for ts in per_warp for t in ts], dtype=np.int32).reshape(-1, 4),
        warp_ptr,
    )


@functools.lru_cache(maxsize=None)
def _tables_on(plan: TensorProductPlan, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=device) for a in kernel_tables(plan))


@functools.lru_cache(maxsize=None)
def _bwd_tables_on(plan: TensorProductPlan, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=device) for a in backward_tables(plan))


class SrcOrder(NamedTuple):
    """The edges in stable src order: what the dx segment sum walks."""

    perm: torch.Tensor  # [E] int32 edge ids sorted by src, ties in edge order
    row_ptr: torch.Tensor  # [n_in + 1] int32 offsets of each source node's edges in perm


def src_order(src: torch.Tensor, n_in: int) -> SrcOrder:
    """Stable argsort of src and its CSR offsets (one sort and one
    searchsorted on the device, no host sync). Every conv layer of a batch
    shares src, so a caller builds this once per batch."""
    src_sorted, perm = torch.sort(src, stable=True)
    return SrcOrder(perm.to(torch.int32), _row_ptr(src_sorted, n_in))


def _check(fn: str, expect: Dict[str, Tuple[torch.Tensor, torch.dtype, Tuple[int, ...]]]) -> None:
    """dtype, shape, contiguity and a common device of a launch's tensors."""
    dev = next(iter(expect.values()))[0].device
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, not on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, needs {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def _edge_checks(plan, sh, src, dst):
    e = sh.shape[0] if sh.dim() == 2 else -1
    return {
        "sh": (sh, torch.float32, (e, plan.irreps_in2.dim)),
        "src": (src, torch.int32, (e,)),
        "dst": (dst, torch.int32, (e,)),
    }


def _check_indices(fn: str, src, dst, n_in: int, n_out: int) -> None:
    """src in [0, n_in), dst non-decreasing in [0, n_out): one device
    reduction and one host sync."""
    if n_in < 0 or n_out < 0:
        raise ValueError(f"{fn}: n_in={n_in}, n_out={n_out}")
    if not dst.numel():
        return
    bad = (src < 0).any() | (src >= n_in).any() | (dst < 0).any() | (dst >= n_out).any()
    bad = bad | (dst[1:] < dst[:-1]).any()
    if bool(bad):
        raise ValueError(
            f"{fn}: dst must be non-decreasing in [0, n_out) and "
            "src in [0, n_in) (collate_graphs sorts edges by destination)"
        )


def _row_ptr(sorted_idx: torch.Tensor, n: int) -> torch.Tensor:
    """CSR offsets [n + 1] of a non-decreasing index array."""
    nodes = torch.arange(n + 1, dtype=torch.int32, device=sorted_idx.device)
    return torch.searchsorted(sorted_idx, nodes, out_int32=True)


def _launch_failed(lib, kind: str, rc: int, plan) -> RuntimeError:
    d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
    n_t = kernel_tables(plan).t_meta.shape[0]
    if kind == "bwd":  # the merged backward stages padded sh rows
        d2 = len(backward_tables(plan).sh_src)
    smem = getattr(lib, f"fused_uvu_conv_{kind}_smem")(d1, d2, dw, dout, n_t)
    return RuntimeError(
        f"fused_uvu_conv_{kind}: kernel launch failed (cudaError {rc}; the plan "
        f"needs {smem} B of shared memory per block)"
    )


def _launch(plan, x, sh, w, src, dst, n_out: int) -> torch.Tensor:
    """K1: out [n_out, dout]."""
    global launches
    from matten_tpu_torch.kernels._build import load_library

    e = sh.shape[0] if sh.dim() == 2 else -1
    _check("fused_uvu_conv", {
        "x": (x, torch.float32, (x.shape[0], plan.irreps_in1.dim)),
        **_edge_checks(plan, sh, src, dst),
        "w": (w, torch.float32, (e, plan.weight_numel)),
    })
    n_in = x.shape[0]
    _check_indices("fused_uvu_conv", src, dst, n_in, n_out)
    dev = x.device
    d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
    out = torch.empty((n_out, dout), dtype=torch.float32, device=dev)
    if n_out == 0:
        return out
    row_ptr = _row_ptr(dst, n_out)
    t_meta, cg, out_meta, out_pw = _tables_on(plan, dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.fused_uvu_conv_fwd(
            x.data_ptr(), sh.data_ptr(), w.data_ptr(), src.data_ptr(),
            row_ptr.data_ptr(), t_meta.data_ptr(), cg.data_ptr(),
            out_meta.data_ptr(), out_pw.data_ptr(), out.data_ptr(),
            n_out, d1, d2, dw, dout, t_meta.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise _launch_failed(lib, "fwd", rc, plan)
    launches += 1
    return out


def _launch_bwd_edges(plan, x, g, sh, w, src, dst, want_dx: bool = True, want_dw: bool = True,
                      check_indices: bool = True):
    """The merged backward kernel: (dxe [E, d1] or None, dw [E, dw] or
    None). `check_indices=False` skips the data check (and its host sync)
    for src/dst that a forward launch checked."""
    global bwd_launches
    from matten_tpu_torch.kernels._build import load_library

    e = sh.shape[0] if sh.dim() == 2 else -1
    _check("fused_uvu_conv_bwd", {
        "x": (x, torch.float32, (x.shape[0], plan.irreps_in1.dim)),
        "g": (g, torch.float32, (g.shape[0], plan.irreps_out.dim)),
        **_edge_checks(plan, sh, src, dst),
        "w": (w, torch.float32, (e, plan.weight_numel)),
    })
    n_out = g.shape[0]
    if check_indices:
        _check_indices("fused_uvu_conv_bwd", src, dst, x.shape[0], n_out)
    dev = g.device
    d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
    dxe = torch.empty((e, d1), dtype=torch.float32, device=dev) if want_dx else None
    dw_out = torch.empty((e, dw), dtype=torch.float32, device=dev) if want_dw else None
    if e == 0 or not (want_dx or want_dw):
        return dxe, dw_out
    t_meta, _, _, _ = _tables_on(plan, dev)
    tables = _bwd_tables_on(plan, dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.fused_uvu_conv_bwd(
            x.data_ptr(), g.data_ptr(), sh.data_ptr(), w.data_ptr(), src.data_ptr(),
            dst.data_ptr(), t_meta.data_ptr(), *(t.data_ptr() for t in tables),
            dw_out.data_ptr() if want_dw else None, dxe.data_ptr() if want_dx else None,
            e, d1, d2, len(tables[2]), dw, dout, t_meta.shape[0], BWD_TILE_EDGES, BWD_WARPS,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise _launch_failed(lib, "bwd", rc, plan)
    bwd_launches += 1
    return dxe, dw_out


def _launch_dx_reduce(dxe: torch.Tensor, order: SrcOrder, n_in: int) -> torch.Tensor:
    """The dx segment sum: dx [n_in, d1], dx[n] = sum of the dxe rows of the
    edges whose source is n, in edge order (nodes with none get zeros)."""
    global dx_reduce_launches
    from matten_tpu_torch.kernels._build import load_library

    e, d1 = dxe.shape
    _check("uvu_conv_dx_reduce", {
        "dxe": (dxe, torch.float32, (e, d1)),
        "perm": (order.perm, torch.int32, (e,)),
        "row_ptr": (order.row_ptr, torch.int32, (n_in + 1,)),
    })
    dx = torch.empty((n_in, d1), dtype=torch.float32, device=dxe.device)
    if n_in == 0 or d1 == 0:
        return dx
    lib = load_library()
    with torch.cuda.device(dxe.device):
        rc = lib.uvu_conv_dx_reduce(
            dxe.data_ptr(), order.perm.data_ptr(), order.row_ptr.data_ptr(), dx.data_ptr(),
            n_in, d1, torch.cuda.current_stream(dxe.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"uvu_conv_dx_reduce: kernel launch failed (cudaError {rc})")
    dx_reduce_launches += 1
    return dx


def _launch_bwd(plan, x, g, sh, w, src, dst, n_in: int, order: Optional[SrcOrder] = None,
                want_dx: bool = True, want_dw: bool = True, check_indices: bool = True):
    """Both backward kernels: (dx [n_in, d1] or None, dw [E, dw] or None)."""
    if x.shape[0] != n_in:
        raise ValueError(f"uvu_conv_bwd: x has {x.shape[0]} rows, n_in={n_in}")
    dxe, dw = _launch_bwd_edges(plan, x, g, sh, w, src, dst, want_dx, want_dw, check_indices)
    if not want_dx:
        return None, dw
    if order is None:
        order = src_order(src, n_in)
    return _launch_dx_reduce(dxe, order, n_in), dw


class _FusedUvuConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh, w, src, dst, plan, n_out, order):
        ctx.save_for_backward(x, sh, w, src, dst)
        ctx.plan, ctx.n_out, ctx.order = plan, n_out, order
        return _launch(plan, x, sh, w, src, dst, n_out)

    @staticmethod
    def backward(ctx, g):
        x, sh, w, src, dst = ctx.saved_tensors
        plan = ctx.plan
        g = g.contiguous()
        dsh = None
        want_dx, want_sh, want_dw = ctx.needs_input_grad[:3]
        # src/dst were checked by the forward launch
        dx, dw = _launch_bwd(plan, x, g, sh, w, src, dst, x.shape[0], ctx.order,
                             want_dx, want_dw, check_indices=False)
        if want_sh:
            # dsh by autograd of the plain version, as the JAX backward does
            with torch.enable_grad():
                s = sh.detach().requires_grad_()
                out = uvu_conv_reference(plan, x.detach(), s, w.detach(), src, dst, ctx.n_out)
                (dsh,) = torch.autograd.grad(out, s, g)
        return dx, dsh, dw, None, None, None, None, None


def _route(fn: str, tensors) -> bool:
    """True: run the plain version (CPU tensors, or `force_plain()`);
    False: launch the kernel (CUDA tensors). Mixed devices raise."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not all(t.device.type == "cuda" for t in tensors):
        raise ValueError(
            f"{fn}: inputs on mixed devices {sorted({str(t.device) for t in tensors})}"
        )
    return _force_plain


def fused_uvu_conv(
    plan: TensorProductPlan,
    x: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_out: int,
    order: Optional[SrcOrder] = None,
) -> torch.Tensor:
    """uvu TP of x[src] with sh under per-edge weights w, summed into dst.

    x [n_in, d1], sh [E, d2], w [E, dw] float32; src, dst [E] int32 with
    dst non-decreasing; returns [n_out, dout]. CPU tensors take the plain
    version; CUDA tensors launch K1 (or raise), and its gradient launches
    the merged backward and the dx segment sum. `order`, `src_order(src,
    n_in)` built once for the batch, saves the backward its own sort."""
    if _route("fused_uvu_conv", (x, sh, w, src, dst)):
        return uvu_conv_reference(plan, x, sh, w, src, dst, n_out)
    return _FusedUvuConv.apply(x, sh, w, src, dst, plan, n_out, order)


def uvu_conv_bwd(
    plan: TensorProductPlan,
    x: torch.Tensor,
    g: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_in: int,
    order: Optional[SrcOrder] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `fused_uvu_conv` with respect to x and w for the output
    cotangent g [n_out, dout]: (dx [n_in, d1], dw [E, dw]). CPU tensors
    take the plain version; CUDA tensors launch the merged backward kernel
    and the dx segment sum (or raise)."""
    if _route("uvu_conv_bwd", (x, g, sh, w, src, dst)):
        return uvu_conv_bwd_reference(plan, x, g, sh, w, src, dst, n_in)
    return _launch_bwd(plan, x, g, sh, w, src, dst, n_in, order)
