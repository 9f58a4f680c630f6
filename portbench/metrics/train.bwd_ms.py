"""Mean milliseconds a step of the step's backward (Trainer.step_times, CUDA events)."""


def read(trace):
    spans = trace.spans.get('train.backward')
    return 1e3 * sum(spans) / len(spans) if spans else None
