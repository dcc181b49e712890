"""The weights both sides start from, made on the device from the seed.

One `torch.Generator` on the device, seeded with the run's seed, draws
every parameter in one call, in the order of their sorted names, as the
model's own initialisation would: N(0, 1) for the e3nn weights (the
tensor products, the linears and the radial MLPs, whose variance the
forward's scaling carries), N(0, 1) / sqrt(fan in) for the species
embedding's `torch.nn.Linear`, ones for the norms' scales and zeros for
every bias. The benchmark hands the same tensors to the port and to the
reference; neither makes its own."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

__all__ = ["make_weights"]


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for (name, shape) pairs (module docstring)."""
    shapes = sorted((name, tuple(shape)) for name, shape in shapes)
    drawn = [(n, s) for n, s in shapes if not n.endswith(("norm.weight", "bias"))]
    numel = [int(torch.Size(s).numel()) for _, s in drawn]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(numel), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (name, shape), part in zip(drawn, flat.split(numel)):
        w = part.view(shape)
        if name.endswith("linear.weight"):
            w = w / shape[-1] ** 0.5
        out[name] = w
    for name, shape in shapes:
        if name.endswith("norm.weight"):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
    return out
