"""Conv kernels (`csrc/fused_conv_bwd.cu`, `csrc/segment_sum.cu`): the
least time of K1's gradient (g, x, sh, w, src, dst -> dx, dw) at each
conv layer's real nodes and edges, in every train step of the traced
span, over the device time of the merged backward and its dx segment sum,
in percent (`work.py`). Moves the cell's training rate."""

from benchmark.work import least_s


def read(span):
    spent = span.trace.seconds("fused_uvu_conv_bwd") + span.trace.seconds("segment_sum_kernel", "true>")
    if spent <= 0:
        return None
    least = sum(least_s(b, f)[0] for _, n, e in span.traced["train"] for b, f in span.work.conv("bwd", n, e))
    return 100.0 * least / spent
