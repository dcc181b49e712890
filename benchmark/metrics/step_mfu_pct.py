"""The whole step: the model's useful float32 operations in the untraced
epochs (every train step's forward, backward and Adam update, every eval
step's forward, at the real nodes, edges and crystals; `work.py`), over
those epochs' host seconds, over the card's float32 peak, in percent.
Moves the cell's training rate."""

from benchmark.work import F32_FLOP_PER_S


def read(span):
    if span.timed_s <= 0 or not span.timed["train"]:
        return None
    flops = (sum(span.work.train_flops(n, e, g) for g, n, e in span.timed["train"])
             + sum(span.work.eval_flops(n, e, g) for g, n, e in span.timed["val"]))
    return 100.0 * flops / span.timed_s / F32_FLOP_PER_S
