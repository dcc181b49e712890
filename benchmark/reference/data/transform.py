"""Irreps-aware target normalization (host-side numpy, jnp-compatible).

Re-implements the reference's MeanNormNormalize / ScalarNormalize
(data/transform.py:59-306): per-irrep standardization in the style of e3nn
BatchNorm — scalars subtract the mean and divide by the norm, higher-order
irreps divide by the norm only. Statistics are a training artifact that
travels with the checkpoint (SURVEY.md §3.5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from benchmark.reference.ops.irreps import Irreps

__all__ = ["MeanNormNormalize", "ScalarNormalize"]


@dataclass
class MeanNormNormalize:
    irreps: Irreps
    mean: Optional[np.ndarray] = None  # [dim]
    norm: Optional[np.ndarray] = None  # [dim]
    normalization: str = "component"
    reduce: str = "mean"
    eps: float = 1e-5
    scale: float = 1.0

    def __post_init__(self):
        self.irreps = Irreps(self.irreps)

    @property
    def initialized(self) -> bool:
        return self.mean is not None and self.norm is not None

    def compute_statistics(self, data: np.ndarray) -> None:
        """data: [num_samples, irreps.dim] (reference data/transform.py:138-218)."""
        data = np.asarray(data, dtype=np.float64)
        all_mean, all_norm = [], []
        ix = 0
        for mul, ir in self.irreps:
            d = ir.dim
            f = data[:, ix : ix + mul * d].reshape(-1, mul, d)
            ix += mul * d
            if ir.l == 0:
                fmean = f.mean(axis=0).reshape(mul)
                f = f - fmean.reshape(1, mul, 1)
            else:
                fmean = np.zeros(mul)
            all_mean.append(np.repeat(fmean, d))
            if self.normalization == "norm":
                fn = (f**2).sum(-1)
            elif self.normalization == "component":
                fn = (f**2).mean(-1)
            else:
                raise ValueError(self.normalization)
            fn = fn.mean(0) if self.reduce == "mean" else fn.max(0)
            fn = np.sqrt(fn + self.eps)
            all_norm.append(np.repeat(fn, d))
        assert ix == data.shape[-1]
        self.mean = np.concatenate(all_mean)
        self.norm = np.concatenate(all_norm)

    def forward(self, x):
        assert self.initialized, "statistics not computed/loaded"
        return (x - self.mean.astype(x.dtype)) / (self.norm.astype(x.dtype) * self.scale)

    def inverse(self, x):
        assert self.initialized, "statistics not computed/loaded"
        return x * (self.norm.astype(x.dtype) * self.scale) + self.mean.astype(x.dtype)

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"mean": self.mean, "norm": self.norm}

    def load_state_dict(self, d: Dict[str, np.ndarray]) -> None:
        self.mean = np.asarray(d["mean"])
        self.norm = np.asarray(d["norm"])


@dataclass
class ScalarNormalize:
    """Per-feature standardization of scalar targets [num_samples, F]."""

    num_features: int
    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None
    eps: float = 1e-10

    @property
    def initialized(self) -> bool:
        return self.mean is not None and self.std is not None

    def compute_statistics(self, data: np.ndarray) -> None:
        data = np.asarray(data, dtype=np.float64).reshape(-1, self.num_features)
        self.mean = data.mean(axis=0)
        self.std = data.std(axis=0) + self.eps

    def forward(self, x):
        assert self.initialized
        return (x - self.mean.astype(x.dtype)) / self.std.astype(x.dtype)

    def inverse(self, x):
        assert self.initialized
        return x * self.std.astype(x.dtype) + self.mean.astype(x.dtype)

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"mean": self.mean, "std": self.std}

    def load_state_dict(self, d: Dict[str, np.ndarray]) -> None:
        self.mean = np.asarray(d["mean"])
        self.std = np.asarray(d["std"])
