"""Bessel and gaussian radial bases, the activations and the
variance-preserving scalar MLP.

Counterpart of `matten_tpu/nn/radial.py`: weights ~ N(0, 1), forward scaled
by 1/sqrt(fan_in), activations rescaled to unit second moment under N(0, 1)
input ("normalize2mom", by the same 128-node Gauss-Hermite rule), over the
same table of activations (ssp, silu, sigmoid, tanh, abs, identity).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "bessel_basis",
    "gaussian_centers",
    "gaussian_basis",
    "soft_one_hot_linspace",
    "normalize2mom",
    "shifted_softplus",
    "ScalarMLP",
    "ACTIVATIONS",
]


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.softplus(x) - float(np.log(2.0))


# the activations by name, in torch and in numpy for the moments
_ACTIVATIONS = {
    "ssp": shifted_softplus,
    "silu": torch.nn.functional.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "abs": torch.abs,
    "identity": lambda x: x,
}

_NP_ACTIVATIONS = {
    "ssp": lambda x: np.logaddexp(x, 0.0) - np.log(2.0),
    "silu": lambda x: x / (1.0 + np.exp(-x)),
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "tanh": np.tanh,
    "abs": np.abs,
    "identity": lambda x: x,
}

ACTIVATIONS = {
    # parity-safe activation names by scalar parity
    1: {"ssp": "ssp", "silu": "silu", "sigmoid": "sigmoid"},  # even
    -1: {"abs": "abs", "tanh": "tanh"},  # odd
}


@functools.lru_cache(maxsize=None)
def _second_moment(name: str) -> float:
    """E_{z~N(0,1)}[act(z)^2] by 128-node Gauss-Hermite quadrature (float64)."""
    nodes, weights = np.polynomial.hermite_e.hermegauss(128)
    w = weights / np.sqrt(2 * np.pi)
    return float((w * _NP_ACTIVATIONS[name](nodes.astype(np.float64)) ** 2).sum())


def normalize2mom(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation scaled so its output has unit second moment under N(0,1)."""
    fn = _ACTIVATIONS[name]
    c = float(1.0 / np.sqrt(_second_moment(name)))
    if abs(c - 1.0) < 1e-4:
        return fn
    return lambda x: fn(x) * c


def bessel_basis(
    x: torch.Tensor, num_basis: int, start: float = 0.0, end: float = 5.0,
    cutoff: bool = True,
) -> torch.Tensor:
    """sqrt(2/c) * sin(n pi x / c) / x on (start, end), zero outside (with
    `cutoff`; without, no window).

    Zero-length (padding) edges map to zero, which keeps them inert."""
    c = end - start
    xs = x[..., None] - start
    n = torch.arange(1, num_basis + 1, dtype=x.dtype, device=x.device)
    safe = torch.where(xs > 1e-10, xs, torch.ones_like(xs))
    out = float(np.sqrt(2.0 / c)) * torch.sin(n * np.pi * safe / c) / safe
    if not cutoff:
        return out
    window = ((xs > 0) & (xs < c)).to(x.dtype)
    return out * window


def gaussian_centers(num_basis: int, start: float = 0.0, end: float = 5.0,
                     cutoff: bool = True) -> Tuple[np.ndarray, float]:
    """(centers, step) of the gaussian basis: `num_basis` centers evenly
    inside (start, end), the ends excluded with `cutoff` (e3nn's layout) and
    included without, and the distance between them."""
    if cutoff:
        centers = np.linspace(start, end, num_basis + 2)[1:-1]
    else:
        centers = np.linspace(start, end, num_basis)
    step = float(centers[1] - centers[0]) if num_basis > 1 else float(end - start)
    return centers, step


@functools.lru_cache(maxsize=None)
def _centers_on(num_basis: int, start: float, end: float, cutoff: bool,
                device: torch.device) -> Tuple[torch.Tensor, float]:
    """The gaussian centers as float32 on `device` (as the JAX package
    computes them, x64 off), copied there once: a copy per forward would
    sync the host with the card."""
    centers, step = gaussian_centers(num_basis, start, end, cutoff)
    return torch.as_tensor(centers, dtype=torch.float32, device=device), step


def gaussian_basis(x: torch.Tensor, centers: torch.Tensor, step: float) -> torch.Tensor:
    """exp(-((x - c_n) / step)^2) * 1.12. No window: zero-length padding
    edges get nonzero values, which the caller's edge mask zeroes."""
    diff = (x[..., None] - centers.to(x.dtype)) / step
    return torch.exp(-diff**2) * 1.12


def soft_one_hot_linspace(
    x: torch.Tensor, start: float, end: float, number: int,
    basis: str = "bessel", cutoff: bool = True,
) -> torch.Tensor:
    """The radial basis [..., number] of x: "bessel" (`bessel_basis`) or
    "gaussian" (`gaussian_basis` over `gaussian_centers`)."""
    if basis == "bessel":
        return bessel_basis(x, number, start, end, cutoff)
    if basis == "gaussian":
        centers, step = _centers_on(int(number), float(start), float(end), bool(cutoff), x.device)
        return gaussian_basis(x, centers, step)
    raise ValueError(f"unsupported basis {basis!r}")


class ScalarMLP(torch.nn.Module):
    """Bias-free fully connected net on invariant scalars, [E, features]
    layout. hs = [in, hidden, ..., out]; hidden layers use `act`
    (normalize2mom'd), the output layer is linear; every layer computes
    h @ W / sqrt(fan_in) with W ~ N(0, 1). No biases: padding edges with a
    zero embedding must keep zero weights."""

    def __init__(self, hs: Sequence[int], act: str, generator: torch.Generator):
        super().__init__()
        self.hs = tuple(int(h) for h in hs)
        self._act = normalize2mom(act)
        for i in range(len(self.hs) - 1):
            w = torch.randn(self.hs[i], self.hs[i + 1], generator=generator)
            self.register_parameter(f"w{i}", torch.nn.Parameter(w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.hs) - 1
        for i in range(n):
            w = getattr(self, f"w{i}")
            x = x @ w.to(x.dtype) / np.sqrt(self.hs[i])
            if i < n - 1:
                x = self._act(x)
        return x
