"""Peak device memory, MiB, allocated over the window
(torch.cuda.max_memory_allocated after a reset; the fullest card)."""


def read(trace):
    if trace.kind != 'train' or not trace.peak_bytes:
        return None
    return trace.peak_bytes / 2.0 ** 20
