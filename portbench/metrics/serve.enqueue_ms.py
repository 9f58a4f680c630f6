"""Mean milliseconds from a request's call to the serve's return, before
the audio copy waits for the card: the host's work of the serving entry
(models/serving.py) and its launches. The benchmark's span."""


def read(trace):
    spans = trace.spans.get('serve.enqueue')
    return 1e3 * sum(spans) / len(spans) if spans else None
