"""Mean milliseconds a step of the step's clip and Adam update (Trainer.step_times, CUDA events)."""


def read(trace):
    spans = trace.spans.get('train.update')
    return 1e3 * sum(spans) / len(spans) if spans else None
