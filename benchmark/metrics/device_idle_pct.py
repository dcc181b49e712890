"""Device: the share of the untraced epochs' host seconds in which no
device operation ran, in percent. The device's busy seconds per epoch
are the trace's (its busy union over the traced epochs), which the
profiler does not lengthen; the seconds are the untraced epochs' own,
which it would. Moves the cell's training rate."""


def read(span):
    if span.timed_s <= 0 or span.trace.busy_s <= 0 or not span.traced_epochs:
        return None
    busy = span.trace.busy_s / span.traced_epochs * span.timed_epochs
    return 100.0 * (1.0 - busy / span.timed_s)
