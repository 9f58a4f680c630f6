"""Share of its roofline, %, of K2, the GRU recurrence (kernels/gru.py):
its least time at the sub-window's launches (the yardstick's operations
and bytes, counted at the window's own inputs) over its device time from
the profiler."""


def read(trace):
    seconds = trace.kernel_seconds('gru_scan')
    least = trace.bounds.get('gru_scan')
    if not seconds or least is None:
        return None
    return 100.0 * least / seconds
