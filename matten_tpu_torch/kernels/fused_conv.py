"""Fused uvu tensor-product convolution: K1 forward and its merged backward.

Counterpart of `matten_tpu/kernels/fused_conv.py`. The forward (K1, the
counterpart of `_build_fwd2`, dispatched by `fused_uvu_conv_t`) computes

    out[n] = sum_{e : dst[e] = n} TP_uvu(x[src[e]], sh[e], w[e])

without storing the [E, dout] messages, as two kernels:

    part[i]   = sum_{e in item i} TP_uvu(x[src[e]], sh[e], w[e])
                (items: runs of at most 16 edges of one destination)
    out[n]    = sum_{items i of n} part[i]               (a segment sum)

Its gradient (`uvu_conv_bwd`) is two kernels, the counterparts of the
merged backward `_build_bwd2` (K2) and of the chunked pair the JAX package
takes beyond 2048 nodes, the transposed `_build_call` (K3) for dx and
`_build_dw_call` (K4) for dw:

    dw[e, k]  = d out[dst[e]] / d w[e, k]  contracted with g[dst[e]]
    dxe[e]    = TP_uvu^T(g[dst[e]], sh[e], w[e])       (one pass over edge tiles)
    dx[n]     = sum_{e : src[e] = n} dxe[e]              (the same segment sum)

On CUDA tensors each wrapper launches its hand-written kernels
(`csrc/fused_conv.cu`, `csrc/fused_conv_bwd.cu`, `csrc/segment_sum.cu`,
built by `_build.py`) or raises; on CPU tensors, or with the "xla" tier
(`fused_tp.set_tp_impl`, `force_plain`), it runs the kernels' plain version
(`uvu_conv_reference`, `uvu_conv_bwd_reference`). The gradient with
respect to sh comes from autograd of the plain forward, and only when sh
requires it, as in the JAX backward.

With `fused_tp.set_kernel_in_dtype("bfloat16")` the kernels read sh and w
stored as bfloat16 (rounded to nearest even inside the autograd Function,
as the JAX v2 kernels cast them inside their custom_vjp), and the plain
versions apply the same rounding before their float32 arithmetic. x, the
cotangent, the arithmetic and every output stay float32: dw comes back in
w's float32 (the gradient at the rounded inputs, not rounded itself), and
dsh from autograd of the plain forward on the unrounded sh and w.

The edges' checks and layout (`EdgePlan`: the dst CSR, K1's items, the src
order) are built once per batch with one host sync, so the launches
themselves never wait on the card. The TPU
machinery of the JAX kernels (transposed [D, E] layout, one-hot-matmul
gathers and scatters, node-chunk owner maps, VMEM budgets, m-major rows)
has no counterpart here: edges arrive sorted by destination, both passes
walk runs of consecutive edges, and every sum into the nodes is a
deterministic segment sum.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from matten_tpu_torch.kernels import fused_tp
from matten_tpu_torch.ops.scatter import scatter_sum
from matten_tpu_torch.ops.tensor_product import TensorProductPlan
from matten_tpu_torch.ops.clebsch_gordan import wigner_3j

__all__ = [
    "fused_uvu_conv",
    "uvu_conv_bwd",
    "uvu_conv_reference",
    "uvu_conv_bwd_reference",
    "EdgePlan",
    "edge_plan",
    "SrcOrder",
    "src_order",
    "force_plain",
]

# kernel launches in this process: K1's item pass (`launches`), the segment
# sum in its two roles (K1's partial rows, dx), the merged backward, and the
# bf16-storage instances of K1's item pass and the merged backward; each is
# added to right where its kernel launches and nothing else touches them
# except a caller resetting them
launches = 0
fwd_sum_launches = 0
bwd_launches = 0
dx_sum_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0

# the kernels' launch shapes (csrc/fused_conv.cu: FWD_TE, FWD_WARPS;
# csrc/fused_conv_bwd.cu: BWD_TE, BWD_WARPS); their task tables are built
# for them and the launches check both
FWD_ITEM_EDGES = 16
FWD_WARPS = 24
BWD_TILE_EDGES = 16
BWD_WARPS = 24
# irreps the kernels take: l <= 4 (d1, d2_i, d3 <= 9), the production range
# (csrc/fused_conv_common.cuh: CONV_MAX_D)
CONV_MAX_D = 9

@contextlib.contextmanager
def force_plain():
    """Run the conv through its plain version on CUDA tensors too (the
    "xla" tier for the block), so a caller can compare the kernel path with
    the plain path."""
    prev = fused_tp.get_tp_impl()
    fused_tp.set_tp_impl("xla")
    try:
        yield
    finally:
        fused_tp.set_tp_impl(prev)


def _stored(t: torch.Tensor) -> torch.Tensor:
    """sh or w in the kernels' storage dtype (`fused_tp.get_kernel_in_dtype`;
    bf16 rounds to nearest even)."""
    return t.to(torch.bfloat16 if fused_tp.get_kernel_in_dtype() == "bfloat16" else torch.float32)


def _conv_sum(plan, x, sh, w, src, dst, n_out: int) -> torch.Tensor:
    msg = plan.apply(x[src.long()], sh, w)
    return scatter_sum(msg, dst, n_out)


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
    (counterpart of `_reference` in the JAX kernel module), with sh and w
    first rounded to the storage dtype, as the kernels read them."""
    return _conv_sum(plan, x, _stored(sh).float(), _stored(w).float(), src, dst, n_out)


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
    """Plain version of the merged backward: (dx [n_in, d1], dw [E, dw]),
    with sh and w first rounded to the storage dtype, as the kernels read
    them."""
    sh, w = _stored(sh).float(), _stored(w).float()
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




class TileTables(NamedTuple):
    """Per-plan constant tables of the edge-run kernels, K1's item pass and
    the merged backward (numpy), derived from the forward's `KernelTables`."""

    cg_t: np.ndarray  # [CONV_MAX_D, n_t] float32: C_i[m2] at [m2, i], 0 past d2_i
    t_sh: np.ndarray  # [n_t] int32: where entry i's sh irrep starts in a padded sh row
    sh_src: np.ndarray  # [padded sh row] int32: sh component of each slot, -1 for padding
    groups: np.ndarray  # [irreps of in1, 4] int32: x_off, d1, path begin, path end
    paths: np.ndarray  # [paths, 4] int32: o_off, t_off, w_off, d3
    path_pw: np.ndarray  # [paths] float32
    tasks: np.ndarray  # backward [tasks, 4] int32: u0 | nu << 16, group, u count, j0 | ne << 16
    warp_ptr: np.ndarray  # [BWD_WARPS + 1] int32: each backward warp's tasks
    fwd_tasks: np.ndarray  # K1 [tasks, 4] int32: path, group, u0 | nu << 16, u count | ne << 16
    fwd_warp_ptr: np.ndarray  # [FWD_WARPS + 1] int32: each K1 warp's tasks


def _deal(tasks, n_warps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tasks, warp_ptr): (cost, task) pairs dealt to n_warps warps,
    heaviest first, each to the warp with the least work so far."""
    load = [0] * n_warps
    per_warp = [[] for _ in range(n_warps)]
    for c, task in sorted(tasks, key=lambda ct: -ct[0]):
        wi = int(np.argmin(load))
        load[wi] += c
        per_warp[wi].append(task)
    return (np.asarray([t for ts in per_warp for t in ts], dtype=np.int32).reshape(-1, 4),
            np.cumsum([0] + [len(t) for t in per_warp]).astype(np.int32))


@functools.lru_cache(maxsize=None)
def tile_tables(plan: TensorProductPlan) -> TileTables:
    """Tables of K1's item pass and the merged backward.

    Channel u of input irrep i reads x at x_off(i) + u d1; its path p has
    the weight k = w_off(p) + u, the output components o_off(p) + u d3 + m3
    and the CG block entries t_off(p) + m1 d3 + m3: so `groups` and `paths`
    hold every channel's entries up to the stride in u. Offsets come from
    the forward's `out_meta` at the first component of each path (u = 0,
    m3 = 0).

    The merged backward: a lane owns one input channel (i, u) of one edge
    and every weight that reads it. The lanes of one warp task hold nu
    consecutive channels u of one irrep (nu = min(mul, 32)) and 32 // nu
    consecutive edges of the tile (work: the lane's multiply-adds).

    K1: a lane owns the d3 outputs of one channel u of one path over a
    group of the item's edges. The lanes of one warp task hold nu channels
    (the power of two at or above min(mul, 32)) and 32 // nu groups of
    edges (strided: edge j in group j % ne), which shuffles add at the end
    (work: the lane's multiply-adds and shuffles).

    The tasks of a tile or item are dealt to the block's warps heaviest
    first, each to the warp with the least work so far."""
    tab = kernel_tables(plan)
    big = [ir for irreps in (plan.irreps_in1, plan.irreps_in2, plan.irreps_out)
           for _, ir in irreps if ir.dim > CONV_MAX_D]
    if big:
        raise ValueError(f"the conv kernels take irreps up to l=4, got {big}")
    n_t = tab.t_meta.shape[0]
    cg_t = np.zeros((CONV_MAX_D, n_t), dtype=np.float32)
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
    bwd_tasks = []  # (cost, task)
    for gi, (mul, _) in enumerate(plan.irreps_in1):
        if not mul:
            continue
        # an irrep without paths still gets tasks: they write its dx rows as zeros
        nu = min(mul, 32)
        ne = min(32 // nu, te)
        for u0 in range(0, mul, nu):
            for j0 in range(0, te, ne):
                task = (u0 | nu << 16, gi, min(nu, mul - u0), j0 | min(ne, te - j0) << 16)
                bwd_tasks.append((cost[gi], task))

    fwd_tasks = []
    for gi, (mul, ir) in enumerate(plan.irreps_in1):
        d1 = ir.dim
        for q in range(groups[gi][2], groups[gi][3]):
            d3 = paths[q][3]
            for u0 in range(0, mul, 32):
                n_u = min(32, mul - u0)
                nu = 1 << (n_u - 1).bit_length()
                ne = min(32 // nu, FWD_ITEM_EDGES)
                work = -(-FWD_ITEM_EDGES // ne) * (d1 * d3 + d1 + d3 + 1) + ((32 // nu).bit_length() - 1) * d3
                fwd_tasks.append((work, (q, gi, u0 | nu << 16, n_u | ne << 16)))
    return TileTables(
        cg_t,
        t_sh,
        np.asarray(sh_src, dtype=np.int32),
        np.asarray(groups, dtype=np.int32).reshape(-1, 4),
        np.asarray(paths, dtype=np.int32).reshape(-1, 4),
        np.asarray(path_pw, dtype=np.float32),
        *_deal(bwd_tasks, BWD_WARPS),
        *_deal(fwd_tasks, FWD_WARPS),
    )


@functools.lru_cache(maxsize=None)
def _tables_on(plan: TensorProductPlan, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=device) for a in kernel_tables(plan))


@functools.lru_cache(maxsize=None)
def _tile_tables_on(plan: TensorProductPlan, device: torch.device) -> TileTables:
    return TileTables(*(torch.as_tensor(a, device=device) for a in tile_tables(plan)))


class SrcOrder(NamedTuple):
    """The edges in stable src order: what the dx segment sum walks."""

    perm: torch.Tensor  # [E] int32 edge ids sorted by src, ties in edge order
    row_ptr: torch.Tensor  # [n_in + 1] int32 offsets of each source node's edges in perm


def src_order(src: torch.Tensor, n_in: int) -> SrcOrder:
    """Stable argsort of src and its CSR offsets (one sort and one
    searchsorted on the device, no host sync)."""
    src_sorted, perm = torch.sort(src, stable=True)
    return SrcOrder(perm.to(torch.int32), _row_ptr(src_sorted, n_in))


class EdgePlan(NamedTuple):
    """A batch's edges as the conv kernels walk them, checked once."""

    src: torch.Tensor  # [E] int32: the edges the plan was built for
    dst: torch.Tensor  # [E] int32, non-decreasing
    n_in: int
    n_out: int
    row_ptr: torch.Tensor  # [n_out + 1] int32 offsets of each destination's edges
    item_ptr: torch.Tensor  # [n_out + 1] int32 offsets of each destination's K1 items
    n_items: int
    order: Optional[SrcOrder]  # the dx segment sum's src order, or None: sorted when needed


def edge_plan(src: torch.Tensor, dst: torch.Tensor, n_in: int, n_out: int,
              with_src_order: bool = False) -> EdgePlan:
    """Check a batch's edges and lay them out for the conv kernels.

    Checks src in [0, n_in) and dst non-decreasing in [0, n_out), with one
    device reduction and one host sync, which also reads K1's item count.
    Lays out the dst CSR offsets and K1's items, the runs of at most
    FWD_ITEM_EDGES consecutive edges of one destination (item_ptr =
    cumsum(ceil(deg / FWD_ITEM_EDGES))), and with `with_src_order` the src
    order of the dx segment sum. Every conv layer of a batch shares its
    edges, so a caller builds this once per batch and hands it to every
    call: the launches then never wait on the card."""
    e = src.shape[0] if src.dim() == 1 else -1
    _check("edge_plan", {"src": (src, torch.int32, (e,)), "dst": (dst, torch.int32, (e,))})
    if n_in < 0 or n_out < 0:
        raise ValueError(f"edge_plan: n_in={n_in}, n_out={n_out}")
    row_ptr = _row_ptr(dst, n_out)
    items = torch.div(row_ptr[1:] - row_ptr[:-1] + FWD_ITEM_EDGES - 1, FWD_ITEM_EDGES,
                      rounding_mode="floor")
    item_ptr = torch.cat([row_ptr.new_zeros(1), torch.cumsum(items, 0, dtype=torch.int32)])
    bad, n_items = False, 0
    if e:
        bad = (src < 0).any() | (src >= n_in).any() | (dst < 0).any() | (dst >= n_out).any()
        bad = bad | (dst[1:] < dst[:-1]).any()
        bad, n_items = torch.stack([bad.to(torch.int32), item_ptr[-1]]).tolist()
    if bad:
        raise ValueError(
            "edge_plan: dst must be non-decreasing in [0, n_out) and "
            "src in [0, n_in) (collate_graphs sorts edges by destination)"
        )
    order = src_order(src, n_in) if with_src_order else None
    return EdgePlan(src, dst, n_in, n_out, row_ptr, item_ptr, n_items, order)


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


def _edge_checks(plan, sh, w, src, dst):
    """sh and w: float32, or both bfloat16 (the kernels' storage instances)."""
    e = sh.shape[0] if sh.dim() == 2 else -1
    store = torch.bfloat16 if sh.dtype == torch.bfloat16 else torch.float32
    return {
        "sh": (sh, store, (e, plan.irreps_in2.dim)),
        "w": (w, store, (e, plan.weight_numel)),
        "src": (src, torch.int32, (e,)),
        "dst": (dst, torch.int32, (e,)),
    }


def _check_plan(fn: str, edges: EdgePlan, src, dst, n_in: int, n_out: int) -> None:
    """The edge plan belongs to these edges and node counts (no device work)."""
    if (edges.src.data_ptr(), edges.dst.data_ptr(), edges.src.shape, edges.n_in, edges.n_out) != (
            src.data_ptr(), dst.data_ptr(), src.shape, n_in, n_out):
        raise ValueError(f"{fn}: the edge plan was built for other edges or node counts")


def _row_ptr(sorted_idx: torch.Tensor, n: int) -> torch.Tensor:
    """CSR offsets [n + 1] of a non-decreasing index array."""
    nodes = torch.arange(n + 1, dtype=torch.int32, device=sorted_idx.device)
    return torch.searchsorted(sorted_idx, nodes, out_int32=True)


def _launch_failed(lib, kind: str, rc: int, plan, in_bytes: int) -> RuntimeError:
    d1, dw, dout = plan.irreps_in1.dim, plan.weight_numel, plan.irreps_out.dim
    n_t = kernel_tables(plan).t_meta.shape[0]
    shp = len(tile_tables(plan).sh_src)  # both kernels stage padded sh rows
    smem = getattr(lib, f"fused_uvu_conv_{kind}_smem")(d1, shp, dw, dout, n_t, in_bytes)
    return RuntimeError(
        f"fused_uvu_conv_{kind}: kernel launch failed (cudaError {rc}; the plan "
        f"needs {smem} B of shared memory per block)"
    )


def _segment_sum(rows: torch.Tensor, ptr: torch.Tensor, perm: Optional[torch.Tensor],
                 n_seg: int) -> torch.Tensor:
    """The segment sum kernel: out [n_seg, width], out[s] = the rows
    (rows[perm[k]] with perm, a permutation of the rows) of k in [ptr[s],
    ptr[s + 1]), in k order; ptr[n_seg] is the number of rows. Its two
    roles are told apart by perm: without, K1's partial rows into dst
    (`fwd_sum_launches`); with, the dx rows into src (`dx_sum_launches`)."""
    global fwd_sum_launches, dx_sum_launches
    from matten_tpu_torch.kernels._build import load_library

    r, width = rows.shape
    expect = {"rows": (rows, torch.float32, (r, width)), "ptr": (ptr, torch.int32, (n_seg + 1,))}
    if perm is not None:
        expect["perm"] = (perm, torch.int32, (r,))
    _check("segment_sum", expect)
    out = torch.empty((n_seg, width), dtype=torch.float32, device=rows.device)
    if n_seg == 0 or width == 0:
        return out
    lib = load_library()
    with torch.cuda.device(rows.device):
        rc = lib.segment_sum(
            rows.data_ptr(), None if perm is None else perm.data_ptr(), ptr.data_ptr(),
            out.data_ptr(), n_seg, width, r, torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"segment_sum: kernel launch failed (cudaError {rc})")
    if perm is None:
        fwd_sum_launches += 1
    else:
        dx_sum_launches += 1
    return out


def _launch_items(plan, x, sh, w, src, edges: EdgePlan) -> torch.Tensor:
    """K1's item pass: the partial rows [items, dout], each item's messages
    summed, for tensors that `_launch` checked (sh and w float32 or bf16)."""
    global launches, bf16_launches
    from matten_tpu_torch.kernels._build import load_library

    dev = x.device
    d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
    partial = torch.empty((edges.n_items, dout), dtype=torch.float32, device=dev)
    if not edges.n_items:
        return partial
    t_meta = _tables_on(plan, dev)[0]
    tt = _tile_tables_on(plan, dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.fused_uvu_conv_fwd(
            x.data_ptr(), sh.data_ptr(), w.data_ptr(), src.data_ptr(),
            edges.row_ptr.data_ptr(), edges.item_ptr.data_ptr(), t_meta.data_ptr(),
            tt.cg_t.data_ptr(), tt.t_sh.data_ptr(), tt.sh_src.data_ptr(),
            tt.groups.data_ptr(), tt.paths.data_ptr(), tt.path_pw.data_ptr(),
            tt.fwd_tasks.data_ptr(), tt.fwd_warp_ptr.data_ptr(), partial.data_ptr(),
            edges.n_items, edges.n_out, d1, d2, len(tt.sh_src), dw, dout, t_meta.shape[0],
            sh.element_size(), FWD_ITEM_EDGES, FWD_WARPS, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise _launch_failed(lib, "fwd", rc, plan, sh.element_size())
    if sh.dtype == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return partial


def _launch_fwd_sum(partial: torch.Tensor, edges: EdgePlan) -> torch.Tensor:
    """K1's partial rows summed per destination in item order: out [n_out,
    dout] (destinations without edges get zeros)."""
    return _segment_sum(partial, edges.item_ptr, None, edges.n_out)


def _launch(plan, x, sh, w, src, dst, n_out: int, edges: Optional[EdgePlan] = None) -> torch.Tensor:
    """K1: its item pass, then the segment sum of the partial rows into
    out [n_out, dout]. Without `edges` it builds (and checks) the plan."""
    _check("fused_uvu_conv", {
        "x": (x, torch.float32, (x.shape[0], plan.irreps_in1.dim)),
        **_edge_checks(plan, sh, w, src, dst),
    })
    if edges is None:
        edges = edge_plan(src, dst, x.shape[0], n_out)
    else:
        _check_plan("fused_uvu_conv", edges, src, dst, x.shape[0], n_out)
    return _launch_fwd_sum(_launch_items(plan, x, sh, w, src, edges), edges)


def _launch_bwd_edges(plan, x, g, sh, w, src, dst, want_dx: bool = True, want_dw: bool = True):
    """The merged backward kernel: (dxe [E, d1] or None, dw [E, dw] float32
    or None), for src and dst that an `edge_plan` checked (sh and w float32
    or bf16)."""
    global bwd_launches, bf16_bwd_launches
    from matten_tpu_torch.kernels._build import load_library

    e = sh.shape[0] if sh.dim() == 2 else -1
    _check("fused_uvu_conv_bwd", {
        "x": (x, torch.float32, (x.shape[0], plan.irreps_in1.dim)),
        "g": (g, torch.float32, (g.shape[0], plan.irreps_out.dim)),
        **_edge_checks(plan, sh, w, src, dst),
    })
    dev = g.device
    d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
    dxe = torch.empty((e, d1), dtype=torch.float32, device=dev) if want_dx else None
    dw_out = torch.empty((e, dw), dtype=torch.float32, device=dev) if want_dw else None
    if e == 0 or not (want_dx or want_dw):
        return dxe, dw_out
    t_meta = _tables_on(plan, dev)[0]
    tt = _tile_tables_on(plan, dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.fused_uvu_conv_bwd(
            x.data_ptr(), g.data_ptr(), sh.data_ptr(), w.data_ptr(), src.data_ptr(),
            dst.data_ptr(), t_meta.data_ptr(), tt.cg_t.data_ptr(), tt.t_sh.data_ptr(),
            tt.sh_src.data_ptr(), tt.groups.data_ptr(), tt.paths.data_ptr(),
            tt.path_pw.data_ptr(), tt.tasks.data_ptr(), tt.warp_ptr.data_ptr(),
            dw_out.data_ptr() if want_dw else None, dxe.data_ptr() if want_dx else None,
            e, d1, d2, len(tt.sh_src), dw, dout, t_meta.shape[0], sh.element_size(),
            BWD_TILE_EDGES, BWD_WARPS, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise _launch_failed(lib, "bwd", rc, plan, sh.element_size())
    if sh.dtype == torch.bfloat16:
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return dxe, dw_out


def _launch_dx_sum(dxe: torch.Tensor, order: SrcOrder, n_in: int) -> torch.Tensor:
    """dx [n_in, d1]: the segment sum of the dxe rows of the edges whose
    source is n, in edge order (nodes with none get zeros)."""
    return _segment_sum(dxe, order.row_ptr, order.perm, n_in)


def _launch_bwd(plan, x, g, sh, w, src, dst, n_in: int, edges: Optional[EdgePlan] = None,
                want_dx: bool = True, want_dw: bool = True):
    """Both backward kernels: (dx [n_in, d1] or None, dw [E, dw] or None).
    Without `edges` it builds (and checks) the plan."""
    if x.shape[0] != n_in:
        raise ValueError(f"uvu_conv_bwd: x has {x.shape[0]} rows, n_in={n_in}")
    n_out = g.shape[0]
    if edges is None:
        edges = edge_plan(src, dst, n_in, n_out, with_src_order=want_dx)
    else:
        _check_plan("uvu_conv_bwd", edges, src, dst, n_in, n_out)
    dxe, dw = _launch_bwd_edges(plan, x, g, sh, w, src, dst, want_dx, want_dw)
    if not want_dx:
        return None, dw
    order = edges.order if edges.order is not None else src_order(src, n_in)
    return _launch_dx_sum(dxe, order, n_in), dw


class _FusedUvuConv(torch.autograd.Function):
    """K1 and its merged backward (`plain`: their plain versions), with sh
    and w cast to the storage dtype here, so that dx and dw come back as the
    float32 gradients at the rounded inputs and dsh at the unrounded ones."""

    @staticmethod
    def forward(ctx, x, sh, w, src, dst, plan, n_out, edges, plain):
        sh_k, w_k = _stored(sh), _stored(w)
        ctx.save_for_backward(x, sh, w, src, dst, sh_k, w_k)
        ctx.plan, ctx.n_out, ctx.edges, ctx.plain = plan, n_out, edges, plain
        if plain:
            return _conv_sum(plan, x, sh_k.float(), w_k.float(), src, dst, n_out)
        return _launch(plan, x, sh_k, w_k, src, dst, n_out, edges)

    @staticmethod
    def backward(ctx, g):
        x, sh, w, src, dst, sh_k, w_k = ctx.saved_tensors
        plan = ctx.plan
        g = g.contiguous()
        dx = dsh = dw = None
        want_dx, want_sh, want_dw = ctx.needs_input_grad[:3]
        if ctx.plain:
            if want_dx:
                dx = uvu_conv_dx_reference(plan, g, sh_k.float(), w_k.float(), src, dst, x.shape[0])
            if want_dw:
                dw = uvu_conv_dw_reference(plan, x, g, sh_k.float(), src, dst)
        else:
            dx, dw = _launch_bwd(plan, x, g, sh_k, w_k, src, dst, x.shape[0], ctx.edges,
                                 want_dx, want_dw)
        if want_sh:
            # dsh by autograd of the plain version on the unrounded sh and
            # w, as the JAX backward does
            with torch.enable_grad():
                s = sh.detach().requires_grad_()
                out = _conv_sum(plan, x.detach(), s, w.detach(), src, dst, ctx.n_out)
                (dsh,) = torch.autograd.grad(out, s, g)
        return dx, dsh, dw, None, None, None, None, None, None


def _route(fn: str, tensors) -> bool:
    """True: run the plain version (CPU tensors, or the "xla" tier);
    False: launch the kernel (CUDA tensors). Mixed devices raise."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not all(t.device.type == "cuda" for t in tensors):
        raise ValueError(
            f"{fn}: inputs on mixed devices {sorted({str(t.device) for t in tensors})}"
        )
    return fused_tp.get_tp_impl() == "xla"


def fused_uvu_conv(
    plan: TensorProductPlan,
    x: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_out: int,
    edges: Optional[EdgePlan] = None,
) -> torch.Tensor:
    """uvu TP of x[src] with sh under per-edge weights w, summed into dst.

    x [n_in, d1], sh [E, d2], w [E, dw] float32; src, dst [E] int32 with
    dst non-decreasing; returns [n_out, dout]. CPU tensors take the plain
    version; CUDA tensors launch K1 (or raise), and its gradient launches
    the merged backward and the dx segment sum. sh and w are read in the
    storage dtype of `fused_tp.get_kernel_in_dtype()`. `edges`,
    `edge_plan(src, dst, n_in, n_out)` built once for the batch, spares the
    call its own checks and their host sync (and, with its src order, the
    backward its sort)."""
    plain = _route("fused_uvu_conv", (x, sh, w, src, dst))
    if plain and fused_tp.get_kernel_in_dtype() == "float32":
        return uvu_conv_reference(plan, x, sh, w, src, dst, n_out)
    if not plain and edges is None:
        edges = edge_plan(src, dst, x.shape[0], n_out)
    return _FusedUvuConv.apply(x, sh, w, src, dst, plan, n_out, edges, plain)


def uvu_conv_bwd(
    plan: TensorProductPlan,
    x: torch.Tensor,
    g: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_in: int,
    edges: Optional[EdgePlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `fused_uvu_conv` with respect to x and w for the output
    cotangent g [n_out, dout]: (dx [n_in, d1], dw [E, dw]), both float32.
    CPU tensors take the plain version; CUDA tensors launch the merged
    backward kernel and the dx segment sum (or raise). sh and w are read
    in the storage dtype of `fused_tp.get_kernel_in_dtype()`."""
    if _route("uvu_conv_bwd", (x, g, sh, w, src, dst)):
        return uvu_conv_bwd_reference(plan, x, g, sh, w, src, dst, n_in)
    return _launch_bwd(plan, x, g, _stored(sh), _stored(w), src, dst, n_in, edges)
