"""Share of its roofline, %, of K5, the GRU recurrence's backward (kernels/gru.py):
its least time at the sub-window's launches (the yardstick's operations
and bytes, counted at the window's own inputs) over its device time from
the profiler."""


def read(trace):
    seconds = trace.kernel_seconds('gru_scan_bwd')
    least = trace.bounds.get('gru_scan_bwd')
    if not seconds or least is None:
        return None
    return 100.0 * least / seconds
