"""Fused uvu tensor-product convolution (K1): wrapper, tables and plain version.

Counterpart of the forward of `matten_tpu/kernels/fused_conv.py`
(`_build_fwd2`, dispatched by `fused_uvu_conv_t`). It computes

    out[n] = sum_{e : dst[e] = n} TP_uvu(x[src[e]], sh[e], w[e])

without storing the [E, dout] messages. On CUDA tensors it launches the
hand-written kernel in `csrc/fused_conv.cu` (built by `_build.py`); on CPU
tensors it runs the plain version `uvu_conv_reference` (gather, then
`plan.apply`, then `index_add_`). The TPU machinery of the JAX kernel
(transposed [D, E] layout, one-hot-matmul gathers and scatters, node-chunk
owner maps, VMEM budgets, m-major rows) has no counterpart here: edges
arrive sorted by destination and the kernel walks each node's CSR segment.

Only the forward exists. Its gradient is the merged backward kernel K2
(`matten_tpu/kernels/fused_conv.py::_build_bwd2`), which is not ported yet:
the backward raises instead of differentiating the plain version.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from matten_tpu.ops.wigner import wigner_3j
from matten_tpu_torch.ops.scatter import scatter_sum
from matten_tpu_torch.ops.tensor_product import TensorProductPlan

__all__ = ["fused_uvu_conv", "uvu_conv_reference", "force_plain"]

# number of K1 kernel launches in this process; the wrapper adds one per
# launch and nothing else touches it except a caller resetting it
launches = 0

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


@functools.lru_cache(maxsize=None)
def _tables_on(plan: TensorProductPlan, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=device) for a in kernel_tables(plan))


def _check_inputs(plan, x, sh, w, src, dst, n_out) -> None:
    dev = x.device
    e = sh.shape[0] if sh.dim() == 2 else -1
    expect = {
        "x": (x, torch.float32, (x.shape[0], plan.irreps_in1.dim)),
        "sh": (sh, torch.float32, (e, plan.irreps_in2.dim)),
        "w": (w, torch.float32, (e, plan.weight_numel)),
        "src": (src, torch.int32, (e,)),
        "dst": (dst, torch.int32, (e,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev:
            raise ValueError(f"fused_uvu_conv: {name} on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"fused_uvu_conv: {name} is {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_uvu_conv: {name} has shape {tuple(t.shape)}, needs {shape}")
        if not t.is_contiguous():
            raise ValueError(f"fused_uvu_conv: {name} is not contiguous")
    if n_out < 0:
        raise ValueError(f"fused_uvu_conv: n_out={n_out}")


def _launch(plan, x, sh, w, src, dst, n_out: int) -> torch.Tensor:
    global launches
    from matten_tpu_torch.kernels._build import load_library

    _check_inputs(plan, x, sh, w, src, dst, n_out)
    dev = x.device
    d1, d2, dw, dout = plan.irreps_in1.dim, plan.irreps_in2.dim, plan.weight_numel, plan.irreps_out.dim
    out = torch.empty((n_out, dout), dtype=torch.float32, device=dev)
    if n_out == 0:
        return out
    n_in = x.shape[0]
    if dst.numel():
        bad = (src < 0).any() | (src >= n_in).any() | (dst < 0).any() | (dst >= n_out).any()
        bad = bad | (dst[1:] < dst[:-1]).any()
        if bool(bad):
            raise ValueError(
                "fused_uvu_conv: dst must be non-decreasing in [0, n_out) and "
                "src in [0, n_in) (collate_graphs sorts edges by destination)"
            )
    nodes = torch.arange(n_out + 1, dtype=torch.int32, device=dev)
    row_ptr = torch.searchsorted(dst, nodes, out_int32=True)

    t_meta, cg, out_meta, out_pw = _tables_on(plan, dev)
    n_t = t_meta.shape[0]
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.fused_uvu_conv_fwd(
            x.data_ptr(), sh.data_ptr(), w.data_ptr(), src.data_ptr(),
            row_ptr.data_ptr(), t_meta.data_ptr(), cg.data_ptr(),
            out_meta.data_ptr(), out_pw.data_ptr(), out.data_ptr(),
            n_out, d1, d2, dw, dout, n_t,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        smem = lib.fused_uvu_conv_fwd_smem(d1, d2, dw, dout, n_t)
        raise RuntimeError(
            f"fused_uvu_conv: kernel launch failed (cudaError {rc}; the plan "
            f"needs {smem} B of shared memory per block)"
        )
    launches += 1
    return out


class _FusedUvuConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh, w, src, dst, plan, n_out):
        return _launch(plan, x, sh, w, src, dst, n_out)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "fused_uvu_conv has no backward yet: it is the merged dx/dw kernel "
            "K2 (matten_tpu/kernels/fused_conv.py::_build_bwd2), not ported"
        )


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
    version; CUDA tensors launch the kernel (or raise)."""
    tensors = (x, sh, w, src, dst)
    if all(t.device.type == "cpu" for t in tensors):
        return uvu_conv_reference(plan, x, sh, w, src, dst, n_out)
    if not all(t.device.type == "cuda" for t in tensors):
        raise ValueError(
            "fused_uvu_conv: inputs on mixed devices "
            f"{sorted({str(t.device) for t in tensors})}"
        )
    if _force_plain:
        return uvu_conv_reference(plan, x, sh, w, src, dst, n_out)
    return _FusedUvuConv.apply(x, sh, w, src, dst, plan, n_out)
