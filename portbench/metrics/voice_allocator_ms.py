"""Device milliseconds a request of K9, the voice allocator's three
kernels (classify, walk, fill), from the profiler."""


def read(trace):
    seconds = trace.kernel_seconds('voice_allocator')
    return None if seconds is None else 1e3 * seconds / trace.units
