"""Share, %, of the traced sub-window in which no operation ran on the
device (its busy seconds from the profiler, averaged over the cards)."""


def read(trace):
    if trace.kind != 'serve' or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
