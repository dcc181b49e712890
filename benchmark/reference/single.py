"""What the reference's copy of the model needs of a mesh and of the conv
kernels, on one device: no mesh axis is ever bound, every collective is
the identity, and the uvu convolution is its plain form, the [E, dout]
messages summed into their destinations. No edge plan is built."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from benchmark.reference.ops.scatter import scatter_sum

NODE_MODES = ("node", "node_ring")
GRAPH_MODES = ("edge",) + NODE_MODES


def bound_axis(data: Mapping[str, Any], name: str):
    raise ValueError(f"the reference runs on one device: no mesh axis {name!r}")


def _identity(x: torch.Tensor, axis: Optional[Any] = None) -> torch.Tensor:
    if axis is not None:
        raise ValueError("the reference runs on one device")
    return x


psum = all_gather = ring_shift = pmin = pmax = _identity


def edge_plan(*args, **kwargs) -> None:
    return None


def item_edges_for(plans, device) -> tuple:
    return ()


def fused_uvu_conv(plan, x, sh, w, src, dst, n_out: int, edges=None) -> torch.Tensor:
    """out[n] = sum over edges e with dst[e] = n of plan(x[src[e]], sh[e], w[e])."""
    return scatter_sum(plan.apply(x[src.long()], sh, w), dst, n_out)
