"""Mean milliseconds a step of the step's forward, from its start to the losses (Trainer.step_times, CUDA events)."""


def read(trace):
    spans = trace.spans.get('train.forward')
    return 1e3 * sum(spans) / len(spans) if spans else None
