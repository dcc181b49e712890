"""Clebsch-Gordan tensor products as static plans + torch contractions.

Counterpart of `matten_tpu/ops/tensor_product.py`. A plan is built from
the shared numpy irreps / Wigner-3j code exactly as the JAX plan is
(instructions, path weights, weight shapes), so the two packages' plans
agree entry for entry; only `apply` runs in torch. Conventions are the
e3nn ones the JAX package fixes: component irrep normalization, element
path normalization, N(0,1) weights with the variance carried by the
forward-pass path weight sqrt(ir_out.dim / fan_in).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.ops.irreps import Irrep, Irreps
from benchmark.reference.ops.clebsch_gordan import wigner_3j

__all__ = [
    "Instruction",
    "TensorProductPlan",
    "fully_connected_tp_plan",
    "uvu_tp_plan",
    "LinearPlan",
]


class Instruction(NamedTuple):
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # "uvw" | "uvu"
    has_weight: bool


class TensorProductPlan:
    """Static tensor-product plan: irreps metadata, instructions, constants.

    The CG tables are numpy float64; `apply` moves them to the input's
    device and dtype once per (device, dtype) and keeps them.
    """

    def __init__(
        self,
        irreps_in1: Irreps,
        irreps_in2: Irreps,
        irreps_out: Irreps,
        instructions: Sequence[Instruction],
    ):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)
        self.instructions = tuple(Instruction(*i) for i in instructions)

        def num_elements(ins: Instruction) -> int:
            if ins.mode == "uvw":
                return self.irreps_in1[ins.i_in1].mul * self.irreps_in2[ins.i_in2].mul
            if ins.mode == "uvu":
                return self.irreps_in2[ins.i_in2].mul
            raise ValueError(f"unsupported mode {ins.mode}")

        # component irrep normalization, element path normalization
        self.path_weights: List[float] = []
        for ins in self.instructions:
            num = self.irreps_out[ins.i_out].ir.dim
            den = sum(num_elements(j) for j in self.instructions if j.i_out == ins.i_out)
            self.path_weights.append(float(np.sqrt(num / max(den, 1))))

        self.weight_shapes: List[Tuple[int, ...]] = []
        for ins in self.instructions:
            mul1 = self.irreps_in1[ins.i_in1].mul
            mul2 = self.irreps_in2[ins.i_in2].mul
            mul_out = self.irreps_out[ins.i_out].mul
            if not ins.has_weight:
                self.weight_shapes.append(())
            elif ins.mode == "uvw":
                self.weight_shapes.append((mul1, mul2, mul_out))
            elif ins.mode == "uvu":
                if mul_out != mul1:
                    raise ValueError("uvu requires mul_out == mul_in1")
                self.weight_shapes.append((mul1, mul2))
        self.weight_numel = int(sum(int(np.prod(s)) for s in self.weight_shapes if s))

        self._in1_slices = self.irreps_in1.slices()
        self._in2_slices = self.irreps_in2.slices()
        self._cg_cache: Dict[Tuple[torch.device, torch.dtype], List[torch.Tensor]] = {}

    # ------------------------------------------------------------------
    def _cgs(self, device: torch.device, dtype: torch.dtype) -> List[torch.Tensor]:
        """Per-instruction CG tables, scaled by the path weight; made outside
        inference mode (a cached inference tensor cannot be saved for the
        backward of a later train step)."""
        key = (device, dtype)
        if key not in self._cg_cache:
            tabs = []
            for ins, pw in zip(self.instructions, self.path_weights):
                l1 = self.irreps_in1[ins.i_in1].ir.l
                l2 = self.irreps_in2[ins.i_in2].ir.l
                l3 = self.irreps_out[ins.i_out].ir.l
                with torch.inference_mode(False):
                    tabs.append(torch.as_tensor(wigner_3j(l1, l2, l3) * pw, dtype=dtype, device=device))
            self._cg_cache[key] = tabs
        return self._cg_cache[key]

    def split_weights(self, w: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """Split a flat [..., weight_numel] tensor into per-instruction blocks."""
        out: List[Optional[torch.Tensor]] = []
        i = 0
        for shape in self.weight_shapes:
            if not shape:
                out.append(None)
                continue
            n = int(np.prod(shape))
            out.append(w[..., i : i + n].reshape(w.shape[:-1] + shape))
            i += n
        return out

    def apply(
        self,
        x1: torch.Tensor,
        x2: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Compute the tensor product.

        Args:
            x1: [..., irreps_in1.dim]
            x2: [..., irreps_in2.dim]
            weights: [weight_numel] (shared), [..., weight_numel]
                (per-element, e.g. from a radial MLP), or None when the plan
                has no weighted instructions.

        Returns:
            [..., irreps_out.dim]
        """
        dtype = x1.dtype
        if self.weight_numel > 0:
            if weights is None:
                raise ValueError("plan has weights but none provided")
            wsplit = self.split_weights(weights)
        else:
            wsplit = [None] * len(self.instructions)
        cgs = self._cgs(x1.device, dtype)

        chunks: List[Optional[torch.Tensor]] = [None] * len(self.irreps_out)
        for n, (ins, w) in enumerate(zip(self.instructions, wsplit)):
            mul1, ir1 = self.irreps_in1[ins.i_in1]
            mul2, ir2 = self.irreps_in2[ins.i_in2]
            mul_out, ir_out = self.irreps_out[ins.i_out]
            b1 = x1[..., self._in1_slices[ins.i_in1]].reshape(
                x1.shape[:-1] + (mul1, ir1.dim)
            )
            b2 = x2[..., self._in2_slices[ins.i_in2]].reshape(
                x2.shape[:-1] + (mul2, ir2.dim)
            )
            # contract the CG table with x2 first: [..., v, i, k]; then
            # pairwise contractions in a fixed order (a three-operand
            # einsum searches for a path on the host at every call)
            t = torch.einsum("...vj,ijk->...vik", b2, cgs[n])
            if ins.mode == "uvw":
                if w is None:
                    raise ValueError("uvw instructions require weights")
                y = torch.einsum("...ui,...vik->...uvk", b1, t)
                res = torch.einsum("...uvk,...uvw->...wk", y, w)
            elif ins.mode == "uvu":
                if w is not None:
                    y = torch.einsum("...ui,...vik->...uvk", b1, t)
                    res = torch.einsum("...uvk,...uv->...uk", y, w)
                else:
                    res = torch.einsum("...ui,...vik->...uk", b1, t)
            else:
                raise ValueError(ins.mode)
            res = res.reshape(res.shape[:-2] + (mul_out * ir_out.dim,))
            chunks[ins.i_out] = res if chunks[ins.i_out] is None else chunks[ins.i_out] + res

        batch_shape = tuple(np.broadcast_shapes(tuple(x1.shape[:-1]), tuple(x2.shape[:-1])))
        out = []
        for i, (mul, ir) in enumerate(self.irreps_out):
            if chunks[i] is None:
                out.append(x1.new_zeros(batch_shape + (mul * ir.dim,)))
            else:
                out.append(chunks[i].expand(batch_shape + (mul * ir.dim,)))
        if not out:
            return x1.new_zeros(batch_shape + (0,))
        return torch.cat(out, dim=-1)

    @property
    def in2_is_onehot_compatible(self) -> bool:
        """True when irreps_in2 is a single scalar (0e) entry and every
        instruction is a weighted uvw path — the species one-hot FCTPs."""
        return (
            len(self.irreps_in2) == 1
            and self.irreps_in2[0].ir == Irrep(0, 1)
            and all(ins.mode == "uvw" and ins.has_weight for ins in self.instructions)
        )

    def apply_onehot2(
        self,
        x1: torch.Tensor,
        idx: torch.Tensor,
        weights: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """`apply(x1, one_hot(idx), weights)` for a one-hot compatible plan,
        by gathering each row's per-species weight matrices instead of
        contracting against the S-wide one-hot (the l (x) 0e -> l CG block is
        delta / sqrt(2l+1)): each uvw path's [u, S, w] table indexed by
        `idx` [N] and contracted "nui,unw->nwi", times the path weight and
        1/sqrt(2l+1). `mask` [N] zeroes rows whose one-hot would be all
        zeros (padded nodes). Counterpart of the JAX function of the same
        name; the gather is `index_select`, so its backward is autograd's
        `index_add_` into the tables."""
        if not self.in2_is_onehot_compatible:
            raise ValueError("plan is not one-hot specializable")
        dtype = x1.dtype
        chunks: List[Optional[torch.Tensor]] = [None] * len(self.irreps_out)
        for ins, pw, w in zip(self.instructions, self.path_weights, self.split_weights(weights)):
            mul1, ir1 = self.irreps_in1[ins.i_in1]
            mul_out, ir_out = self.irreps_out[ins.i_out]
            b1 = x1[..., self._in1_slices[ins.i_in1]].reshape(x1.shape[:-1] + (mul1, ir1.dim))
            c0 = float(wigner_3j(ir1.l, 0, ir1.l)[0, 0, 0])  # 1/sqrt(2l+1)
            w_sel = torch.index_select(w, 1, idx).to(dtype)  # [u, N, w]
            res = torch.einsum("nui,unw->nwi", b1, w_sel) * (pw * c0)
            res = res.reshape(res.shape[:-2] + (mul_out * ir_out.dim,))
            chunks[ins.i_out] = res if chunks[ins.i_out] is None else chunks[ins.i_out] + res
        out = [x1.new_zeros(x1.shape[:-1] + (mul * ir.dim,)) if c is None else c
               for c, (mul, ir) in zip(chunks, self.irreps_out)]
        res = torch.cat(out, dim=-1)
        if mask is not None:
            res = res * mask[:, None].to(dtype)
        return res

    def __repr__(self) -> str:
        return (
            f"TensorProductPlan({self.irreps_in1} x {self.irreps_in2} "
            f"-> {self.irreps_out} | {len(self.instructions)} paths, "
            f"{self.weight_numel} weights)"
        )


def fully_connected_tp_plan(
    irreps_in1: Irreps, irreps_in2: Irreps, irreps_out: Irreps
) -> TensorProductPlan:
    """All allowed uvw paths into irreps_out (e3nn FullyConnectedTensorProduct)."""
    irreps_in1 = Irreps(irreps_in1)
    irreps_in2 = Irreps(irreps_in2)
    irreps_out = Irreps(irreps_out)
    instructions = [
        Instruction(i, j, k, "uvw", True)
        for i, (_, ir1) in enumerate(irreps_in1)
        for j, (_, ir2) in enumerate(irreps_in2)
        for k, (_, ir_out) in enumerate(irreps_out)
        if ir_out in ir1 * ir2
    ]
    return TensorProductPlan(irreps_in1, irreps_in2, irreps_out, instructions)


def uvu_tp_plan(
    irreps_in1: Irreps, irreps_in2: Irreps, irreps_out_filter: Irreps
) -> TensorProductPlan:
    """Channel-wise (uvu) weighted TP: every l1 (x) l2 -> l3 path with l3 in
    `irreps_out_filter` or l3 == 0e, one output entry per path, entries
    sorted by irrep. `plan.irreps_out` may differ from the filter."""
    irreps_in1 = Irreps(irreps_in1)
    irreps_in2 = Irreps(irreps_in2)
    irreps_out_filter = Irreps(irreps_out_filter)

    irreps_mid = []
    instructions = []
    for i, (mul, ir1) in enumerate(irreps_in1):
        for j, (_, ir2) in enumerate(irreps_in2):
            for ir_out in ir1 * ir2:
                if ir_out in irreps_out_filter or ir_out == Irrep(0, 1):
                    k = len(irreps_mid)
                    irreps_mid.append((mul, ir_out))
                    instructions.append(Instruction(i, j, k, "uvu", True))
    if not irreps_mid:
        raise ValueError(
            f"{irreps_in1} x {irreps_in2} produces no paths into {irreps_out_filter}"
        )
    irreps_mid, perm, _ = Irreps(irreps_mid).sort()
    instructions = [
        Instruction(ins.i_in1, ins.i_in2, perm[ins.i_out], ins.mode, ins.has_weight)
        for ins in instructions
    ]
    return TensorProductPlan(irreps_in1, irreps_in2, irreps_mid, instructions)


class LinearPlan:
    """Equivariant linear map (e3nn o3.Linear, no bias): every input entry to
    every output entry of the same irrep, scaled by 1/sqrt(fan_in)."""

    def __init__(self, irreps_in: Irreps, irreps_out: Irreps):
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self.connections: List[Tuple[int, int]] = [
            (i, j)
            for i, (_, ir_in) in enumerate(self.irreps_in)
            for j, (_, ir_out) in enumerate(self.irreps_out)
            if ir_in == ir_out
        ]
        self.weight_shapes = [
            (self.irreps_in[i].mul, self.irreps_out[j].mul) for i, j in self.connections
        ]
        self.weight_numel = int(sum(int(np.prod(s)) for s in self.weight_shapes))
        self._fan_in = [
            sum(self.irreps_in[i].mul for i, jj in self.connections if jj == j)
            for j in range(len(self.irreps_out))
        ]
        self._in_slices = self.irreps_in.slices()

    def apply(self, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        chunks: List[Optional[torch.Tensor]] = [None] * len(self.irreps_out)
        wi = 0
        for i, j in self.connections:
            mul_in, ir = self.irreps_in[i]
            mul_out = self.irreps_out[j].mul
            n = mul_in * mul_out
            w = weights[wi : wi + n].reshape(mul_in, mul_out)
            wi += n
            blk = x[..., self._in_slices[i]].reshape(x.shape[:-1] + (mul_in, ir.dim))
            res = torch.einsum("...ui,uv->...vi", blk, w.to(dtype))
            res = res / np.sqrt(self._fan_in[j])
            res = res.reshape(res.shape[:-2] + (mul_out * ir.dim,))
            chunks[j] = res if chunks[j] is None else chunks[j] + res
        out = []
        for j, (mul, ir) in enumerate(self.irreps_out):
            if chunks[j] is None:
                out.append(x.new_zeros(x.shape[:-1] + (mul * ir.dim,)))
            else:
                out.append(chunks[j])
        return torch.cat(out, dim=-1)

    def __repr__(self) -> str:
        return f"LinearPlan({self.irreps_in} -> {self.irreps_out}, {self.weight_numel} weights)"
