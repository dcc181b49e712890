"""Equivariant gate and norm nonlinearities.

Counterpart of `matten_tpu/nn/gate.py`: `ActivationInfo` decides, from the
tensor-product inputs and the intended output irreps, which scalars, gates
and gated irreps are producible; `Gate` applies
[scalars | gates | gated] -> [act(scalars) | act(gates) * gated], and
`NormActivation` scales each irrep channel by act(|x|) / |x|.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.ops.irreps import Irrep, Irreps, tp_path_exists
from benchmark.reference.nn.radial import normalize2mom

__all__ = ["ActivationInfo", "Gate", "NormActivation"]


class ActivationInfo:
    """Static plan for the activation following a TFN convolution.
    "gate": irreps_in = scalars + gates + gated (what the conv must
    output), irreps_out = scalars + gated (post-activation features);
    "norm": irreps_in = irreps_out = (scalars + gated).simplify(), no
    gates. `activation_scalars` / `activation_gates` name the activation
    (`nn.radial`'s table) of the scalars / gates of each parity, {"e": ...,
    "o": ...}."""

    # parity-safe activations by scalar parity (the JAX defaults)
    ACT_SCALARS = {"e": "silu", "o": "tanh"}
    ACT_GATES = {"e": "sigmoid", "o": "tanh"}

    def __init__(
        self,
        tp_irreps_in1: Irreps,
        tp_irreps_in2: Irreps,
        tp_irreps_out: Irreps,
        activation_type: str = "gate",
        activation_scalars: Optional[Mapping[str, str]] = None,
        activation_gates: Optional[Mapping[str, str]] = None,
    ):
        if activation_type not in ("gate", "norm"):
            raise ValueError(f"unsupported activation_type {activation_type!r}")
        activation_scalars = dict(activation_scalars or self.ACT_SCALARS)
        activation_gates = dict(activation_gates or self.ACT_GATES)
        self.activation_type = activation_type
        tp_irreps_out = Irreps(tp_irreps_out).sort()[0].simplify()
        self.irreps_scalars = Irreps(
            [
                (mul, ir)
                for mul, ir in tp_irreps_out
                if ir.l == 0 and tp_path_exists(tp_irreps_in1, tp_irreps_in2, ir)
            ]
        )
        self.irreps_gated = Irreps(
            [
                (mul, ir)
                for mul, ir in tp_irreps_out
                if ir.l > 0 and tp_path_exists(tp_irreps_in1, tp_irreps_in2, ir)
            ]
        )
        if activation_type == "norm":
            self.irreps_gates = Irreps()
            self.irreps_in = (self.irreps_scalars + self.irreps_gated).simplify()
            self.irreps_out = self.irreps_in
        else:
            if self.irreps_gated.dim > 0:
                if tp_path_exists(tp_irreps_in1, tp_irreps_in2, "0e"):
                    gate_ir = Irrep(0, 1)
                elif tp_path_exists(tp_irreps_in1, tp_irreps_in2, "0o"):
                    gate_ir = Irrep(0, -1)
                else:
                    raise ValueError(
                        f"{tp_irreps_in1} x {tp_irreps_in2} cannot produce gate "
                        f"scalars for {self.irreps_gated}"
                    )
                self.irreps_gates = Irreps(
                    [(mul, gate_ir) for mul, _ in self.irreps_gated]
                ).simplify()
            else:
                self.irreps_gates = Irreps()
            self.irreps_in = self.irreps_scalars + self.irreps_gates + self.irreps_gated
            gate_p = self.irreps_gates[0].ir.p if self.irreps_gates else 1
            self.irreps_out = self.irreps_scalars + Irreps(
                [(mul, Irrep(ir.l, ir.p * gate_p)) for mul, ir in self.irreps_gated]
            )

        def _act_name(table: Dict[str, str], p: int) -> str:
            return table["e" if p == 1 else "o"]

        self.act_scalars: Tuple[Tuple[int, str], ...] = tuple(
            (mul, _act_name(activation_scalars, ir.p)) for mul, ir in self.irreps_scalars
        )
        self.act_gates: Tuple[Tuple[int, str], ...] = tuple(
            (mul, _act_name(activation_gates, ir.p)) for mul, ir in self.irreps_gates
        )
        self.act_scalar_even = _act_name(activation_scalars, 1)

    def make(self) -> torch.nn.Module:
        """The activation module of this plan."""
        if self.activation_type == "gate":
            return Gate(self)
        return NormActivation(self.irreps_in, self.act_scalar_even)


class Gate(torch.nn.Module):
    """[scalars | gates | gated] -> [act(scalars) | act(gates) * gated]."""

    def __init__(self, info: ActivationInfo):
        super().__init__()
        self.info = info
        idx, base = [], 0
        for mul, ir in info.irreps_gated:
            idx.append(np.repeat(base + np.arange(mul), ir.dim))
            base += mul
        gate_index = np.concatenate(idx) if idx else np.zeros(0, np.int64)
        self.register_buffer(
            "gate_index", torch.as_tensor(gate_index, dtype=torch.long), persistent=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        info = self.info
        n_s = info.irreps_scalars.dim
        n_g = info.irreps_gates.dim
        scalars = x[..., :n_s]
        gates = x[..., n_s : n_s + n_g]
        gated = x[..., n_s + n_g :]

        out = []
        i = 0
        for mul, name in info.act_scalars:
            out.append(normalize2mom(name)(scalars[..., i : i + mul]))
            i += mul
        acted_gates = []
        i = 0
        for mul, name in info.act_gates:
            acted_gates.append(normalize2mom(name)(gates[..., i : i + mul]))
            i += mul
        if acted_gates:
            g = torch.cat(acted_gates, dim=-1)
            out.append(gated * g[..., self.gate_index])
        elif gated.shape[-1]:
            out.append(gated)
        return torch.cat(out, dim=-1)


class NormActivation(torch.nn.Module):
    """x_ch -> x_ch * act(n) / n per irrep channel, n = sqrt(|x_ch|^2 +
    eps^2) (e3nn NormActivation with normalize=True, no bias); scalar
    entries get act(x). act is normalize2mom'd."""

    EPS = 1e-8

    def __init__(self, irreps: Irreps, act: str = "silu"):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.act = act
        self._fn = normalize2mom(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = []
        off = 0
        for mul, ir in self.irreps:
            blk = x[..., off : off + mul * ir.dim]
            off += mul * ir.dim
            if ir.l == 0:
                out.append(self._fn(blk))
                continue
            blk = blk.reshape(blk.shape[:-1] + (mul, ir.dim))
            n = torch.sqrt((blk**2).sum(dim=-1, keepdim=True) + self.EPS**2)
            blk = blk * (self._fn(n) / n)
            out.append(blk.reshape(blk.shape[:-2] + (mul * ir.dim,)))
        return torch.cat(out, dim=-1)
