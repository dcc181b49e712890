"""Bessel and gaussian radial bases and the variance-preserving scalar MLP.

Counterpart of `matten_tpu/nn/radial.py`: weights ~ N(0, 1), forward scaled
by 1/sqrt(fan_in), hidden activations rescaled to unit second moment under
N(0, 1) input ("normalize2mom", by the same 128-node Gauss-Hermite rule).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

__all__ = ["bessel_basis", "gaussian_centers", "gaussian_basis", "normalize2mom", "ScalarMLP"]


# the activations the model uses (radial MLP: silu; gate: silu / tanh on
# scalars, sigmoid / tanh on gates), in torch and in numpy for the moments
_ACTIVATIONS = {
    "silu": torch.nn.functional.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}

_NP_ACTIVATIONS = {
    "silu": lambda x: x / (1.0 + np.exp(-x)),
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "tanh": np.tanh,
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
    x: torch.Tensor, num_basis: int, start: float = 0.0, end: float = 5.0
) -> torch.Tensor:
    """sqrt(2/c) * sin(n pi x / c) / x on (start, end), zero outside.

    Zero-length (padding) edges map to zero, which keeps them inert."""
    c = end - start
    xs = x[..., None] - start
    n = torch.arange(1, num_basis + 1, dtype=x.dtype, device=x.device)
    safe = torch.where(xs > 1e-10, xs, torch.ones_like(xs))
    out = float(np.sqrt(2.0 / c)) * torch.sin(n * np.pi * safe / c) / safe
    window = ((xs > 0) & (xs < c)).to(x.dtype)
    return out * window


def gaussian_centers(num_basis: int, start: float = 0.0, end: float = 5.0) -> Tuple[np.ndarray, float]:
    """(centers, step) of the gaussian basis: `num_basis` centers evenly
    inside (start, end), the ends excluded (e3nn's cutoff=True layout), and
    the distance between them."""
    centers = np.linspace(start, end, num_basis + 2)[1:-1]
    step = float(centers[1] - centers[0]) if num_basis > 1 else float(end - start)
    return centers, step


def gaussian_basis(x: torch.Tensor, centers: torch.Tensor, step: float) -> torch.Tensor:
    """exp(-((x - c_n) / step)^2) * 1.12. No window: zero-length padding
    edges get nonzero values, which the caller's edge mask zeroes."""
    diff = (x[..., None] - centers.to(x.dtype)) / step
    return torch.exp(-diff**2) * 1.12


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
