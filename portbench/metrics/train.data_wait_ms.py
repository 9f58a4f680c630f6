"""Mean milliseconds a step of the wait for the next staged batch: the benchmark's span around next() of Trainer.device_prefetch's iterator."""


def read(trace):
    spans = trace.spans.get('train.data_wait')
    return 1e3 * sum(spans) / len(spans) if spans else None
