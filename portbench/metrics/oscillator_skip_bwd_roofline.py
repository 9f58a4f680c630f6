"""Share of its roofline, %, of K4, the skipping oscillator's backward (kernels/oscillator.py):
its least time at the sub-window's launches (the yardstick's operations
and bytes, counted at the window's own inputs) over its device time from
the profiler."""


def read(trace):
    seconds = trace.kernel_seconds('oscillator_skip_bwd')
    least = trace.bounds.get('oscillator_skip_bwd')
    if not seconds or least is None:
        return None
    return 100.0 * least / seconds
