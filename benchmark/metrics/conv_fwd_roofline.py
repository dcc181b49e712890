"""Conv kernels (`kernels/fused_conv.py`, `csrc/fused_conv.cu`,
`csrc/segment_sum.cu`): the least time of K1's function (x, sh, w, src,
dst -> out) at each conv layer's real nodes and edges, in every train and
eval step of the traced span, over the device time of K1's item pass and
its partial-row segment sum, in percent. Each layer's least time is the
larger of its bytes over the HBM rate and its operations over the float32
peak (`work.py`). Moves the cell's training rate."""

from benchmark.work import least_s


def read(span):
    spent = span.trace.seconds("fused_uvu_conv_fwd") + span.trace.seconds("segment_sum_kernel", "false>")
    if spent <= 0:
        return None
    steps = span.traced["train"] + span.traced["val"]
    least = sum(least_s(b, f)[0] for _, n, e in steps for b, f in span.work.conv("fwd", n, e))
    return 100.0 * least / spent
