"""Fused uvu tensor-product convolution: K1 forward, dx and dw backward.

Counterpart of `matten_tpu/kernels/fused_conv.py`. The forward (K1, the
counterpart of `_build_fwd2`, dispatched by `fused_uvu_conv_t`) computes

    out[n] = sum_{e : dst[e] = n} TP_uvu(x[src[e]], sh[e], w[e])

without storing the [E, dout] messages. Its gradient is two kernels, the
counterparts of the merged backward `_build_bwd2` (K2) and of the chunked
pair the JAX package takes beyond 2048 nodes, the transposed `_build_call`
(K3) for dx and `_build_dw_call` (K4) for dw:

    dx[n]    = sum_{e : src[e] = n} TP_uvu^T(g[dst[e]], sh[e], w[e])
    dw[e, k] = d out[dst[e]] / d w[e, k]  contracted with g[dst[e]]

On CUDA tensors each wrapper launches its hand-written kernel
(`csrc/fused_conv.cu`, `csrc/fused_conv_bwd.cu`, built by `_build.py`) or
raises; on CPU tensors it runs the kernel's plain version
(`uvu_conv_reference`, `uvu_conv_dx_reference`, `uvu_conv_dw_reference`).
The gradient with respect to sh comes from autograd of the plain forward,
and only when sh requires it, as in the JAX backward. The TPU machinery of
the JAX kernels (transposed [D, E] layout, one-hot-matmul gathers and
scatters, node-chunk owner maps, VMEM budgets, m-major rows) has no
counterpart here: edges arrive sorted by destination, the forward and dw
kernels walk each destination's CSR segment, and the dx kernel walks a
stable src-sorted permutation of the edges.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from matten_tpu_torch.ops.scatter import scatter_sum
from matten_tpu_torch.ops.tensor_product import TensorProductPlan
from matten_tpu_torch.ops.wigner import wigner_3j

__all__ = [
    "fused_uvu_conv",
    "uvu_conv_dx",
    "uvu_conv_dw",
    "uvu_conv_reference",
    "uvu_conv_dx_reference",
    "uvu_conv_dw_reference",
    "force_plain",
]

# kernel launches in this process: K1 (`launches`), the dx and the dw
# kernel; each wrapper adds one per launch of its kernel and nothing else
# touches them except a caller resetting them
launches = 0
dx_launches = 0
dw_launches = 0

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


def uvu_conv_dx_reference(
    plan: TensorProductPlan,
    g: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_in: int,
) -> torch.Tensor:
    """Plain version of dx: the messages are linear in x[src], so the
    per-edge cotangent g[dst] goes back through `plan.apply` by autograd
    ([E, d1]) and is segment-summed into src."""
    with torch.enable_grad():
        xe = sh.new_zeros((sh.shape[0], plan.irreps_in1.dim), requires_grad=True)
        msg = plan.apply(xe, sh.detach(), w.detach())
        (dxe,) = torch.autograd.grad(msg, xe, g[dst.long()])
    return scatter_sum(dxe, src, n_in)


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
    """Per-plan constant tables of the dx and dw kernels (numpy), derived
    from the forward's `KernelTables`."""

    dx_ptr: np.ndarray  # [d1 + 1] int32: CSR offsets of each input component's entries
    dx_meta: np.ndarray  # [n_dx, 4] int32: o base, t base, d3, 0
    dw_meta: np.ndarray  # [dw, 4] int32: x base, t offset, o base, d1 | d3 << 16


@functools.lru_cache(maxsize=None)
def backward_tables(plan: TensorProductPlan) -> BackwardTables:
    """Tables of the backward kernels.

    Weight k = (path p, channel u) owns the output components o_base + m3
    (m3 < d3), all with w index k; the first of them in the forward's
    `out_meta` gives its x base, CG-block offset and (d1, d3). Input
    component c = x_base(k) + m1 is read by every k whose x range holds
    it, through t entries t_off(k) + m1 * d3 + m3: its dx entries are
    (o_base(k), t_off(k) + m1 * d3, d3), in the order of k."""
    out_meta = kernel_tables(plan).out_meta
    # the first output component of each weight, in weight order
    _, first = np.unique(out_meta[:, 2], return_index=True)
    dw_meta = np.stack(
        [out_meta[first, 0], out_meta[first, 1], first, out_meta[first, 3]], axis=1
    ).astype(np.int32)
    entries = [[] for _ in range(plan.irreps_in1.dim)]
    for x_base, t_off, o_base, dims in dw_meta:
        d1, d3 = int(dims) & 0xFFFF, int(dims) >> 16
        for m1 in range(d1):
            entries[x_base + m1].append((o_base, t_off + m1 * d3, d3, 0))
    dx_ptr = np.cumsum([0] + [len(e) for e in entries]).astype(np.int32)
    dx_meta = np.asarray([e for es in entries for e in es], dtype=np.int32).reshape(-1, 4)
    return BackwardTables(dx_ptr, dx_meta, dw_meta)


@functools.lru_cache(maxsize=None)
def _tables_on(plan: TensorProductPlan, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=device) for a in kernel_tables(plan))


@functools.lru_cache(maxsize=None)
def _bwd_tables_on(plan: TensorProductPlan, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=device) for a in backward_tables(plan))


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


def _launch_dx(plan, g, sh, w, src, dst, n_in: int, check_indices: bool = True) -> torch.Tensor:
    """dx kernel: dx [n_in, d1]. `check_indices=False` skips the data
    check (and its host sync) for src/dst that a forward launch checked."""
    global dx_launches
    from matten_tpu_torch.kernels._build import load_library

    e = sh.shape[0] if sh.dim() == 2 else -1
    _check("uvu_conv_dx", {
        "g": (g, torch.float32, (g.shape[0], plan.irreps_out.dim)),
        **_edge_checks(plan, sh, src, dst),
        "w": (w, torch.float32, (e, plan.weight_numel)),
    })
    if check_indices:
        _check_indices("uvu_conv_dx", src, dst, n_in, g.shape[0])
    dev = g.device
    d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
    dx = torch.empty((n_in, d1), dtype=torch.float32, device=dev)
    if n_in == 0:
        return dx
    src_sorted, perm = torch.sort(src, stable=True)
    perm = perm.to(torch.int32)
    row_ptr = _row_ptr(src_sorted, n_in)
    t_meta, cg, out_meta, out_pw = _tables_on(plan, dev)
    dx_ptr, dx_meta, _ = _bwd_tables_on(plan, dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.fused_uvu_conv_dx(
            g.data_ptr(), sh.data_ptr(), w.data_ptr(), dst.data_ptr(),
            perm.data_ptr(), row_ptr.data_ptr(), t_meta.data_ptr(), cg.data_ptr(),
            out_meta.data_ptr(), out_pw.data_ptr(), dx_ptr.data_ptr(),
            dx_meta.data_ptr(), dx.data_ptr(),
            n_in, d1, d2, dw, dout, t_meta.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise _launch_failed(lib, "dx", rc, plan)
    dx_launches += 1
    return dx


def _launch_dw(plan, x, g, sh, src, dst, check_indices: bool = True) -> torch.Tensor:
    """dw kernel: dw [E, dw]. `check_indices` as in `_launch_dx`."""
    global dw_launches
    from matten_tpu_torch.kernels._build import load_library

    _check("uvu_conv_dw", {
        "x": (x, torch.float32, (x.shape[0], plan.irreps_in1.dim)),
        "g": (g, torch.float32, (g.shape[0], plan.irreps_out.dim)),
        **_edge_checks(plan, sh, src, dst),
    })
    n_out = g.shape[0]
    if check_indices:
        _check_indices("uvu_conv_dw", src, dst, x.shape[0], n_out)
    dev = x.device
    d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
    out = torch.empty((sh.shape[0], dw), dtype=torch.float32, device=dev)
    if n_out == 0 or sh.shape[0] == 0:
        return out
    row_ptr = _row_ptr(dst, n_out)
    t_meta, cg, _, out_pw = _tables_on(plan, dev)
    _, _, dw_meta = _bwd_tables_on(plan, dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.fused_uvu_conv_dw(
            x.data_ptr(), g.data_ptr(), sh.data_ptr(), src.data_ptr(),
            row_ptr.data_ptr(), t_meta.data_ptr(), cg.data_ptr(), out_pw.data_ptr(),
            dw_meta.data_ptr(), out.data_ptr(),
            n_out, d1, d2, dw, dout, t_meta.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise _launch_failed(lib, "dw", rc, plan)
    dw_launches += 1
    return out


class _FusedUvuConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh, w, src, dst, plan, n_out):
        ctx.save_for_backward(x, sh, w, src, dst)
        ctx.plan, ctx.n_out = plan, n_out
        return _launch(plan, x, sh, w, src, dst, n_out)

    @staticmethod
    def backward(ctx, g):
        x, sh, w, src, dst = ctx.saved_tensors
        plan = ctx.plan
        g = g.contiguous()
        dx = dsh = dw = None
        # src/dst were checked by the forward launch
        if ctx.needs_input_grad[0]:
            dx = _launch_dx(plan, g, sh, w, src, dst, x.shape[0], check_indices=False)
        if ctx.needs_input_grad[2]:
            dw = _launch_dw(plan, x, g, sh, src, dst, check_indices=False)
        if ctx.needs_input_grad[1]:
            # dsh by autograd of the plain version, as the JAX backward does
            with torch.enable_grad():
                s = sh.detach().requires_grad_()
                out = uvu_conv_reference(plan, x.detach(), s, w.detach(), src, dst, ctx.n_out)
                (dsh,) = torch.autograd.grad(out, s, g)
        return dx, dsh, dw, None, None, None, None


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
) -> torch.Tensor:
    """uvu TP of x[src] with sh under per-edge weights w, summed into dst.

    x [n_in, d1], sh [E, d2], w [E, dw] float32; src, dst [E] int32 with
    dst non-decreasing; returns [n_out, dout]. CPU tensors take the plain
    version; CUDA tensors launch K1 (or raise), and its gradient launches
    the dx and dw kernels."""
    if _route("fused_uvu_conv", (x, sh, w, src, dst)):
        return uvu_conv_reference(plan, x, sh, w, src, dst, n_out)
    return _FusedUvuConv.apply(x, sh, w, src, dst, plan, n_out)


def uvu_conv_dx(
    plan: TensorProductPlan,
    g: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_in: int,
) -> torch.Tensor:
    """Gradient of `fused_uvu_conv` with respect to x, for the output
    cotangent g [n_out, dout]: [n_in, d1]. CPU tensors take the plain
    version; CUDA tensors launch the dx kernel (or raise)."""
    if _route("uvu_conv_dx", (g, sh, w, src, dst)):
        return uvu_conv_dx_reference(plan, g, sh, w, src, dst, n_in)
    return _launch_dx(plan, g, sh, w, src, dst, n_in)


def uvu_conv_dw(
    plan: TensorProductPlan,
    x: torch.Tensor,
    g: torch.Tensor,
    sh: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """Gradient of `fused_uvu_conv` with respect to w, for the output
    cotangent g [n_out, dout]: [E, dw]. CPU tensors take the plain version;
    CUDA tensors launch the dw kernel (or raise)."""
    if _route("uvu_conv_dw", (x, g, sh, src, dst)):
        return uvu_conv_dw_reference(plan, x, g, sh, src, dst)
    return _launch_dw(plan, x, g, sh, src, dst)
