"""Share of its roofline, %, of K10, the surrogate synth's decaying-partial
oscillator (kernels/oscillator_decay.py): its least time at the
sub-window's launches over its device time from the profiler. The least
time is the yardstick's K1 count of the same live terms
(``bounds['oscillator_skip']``, which the reference's decay render feeds
through the oscillator's control hooks): it leaves out the envelope's
work and the decays' bytes, so it is a lower bound. The profiler's events
of K10 are held to its launch counter here; None where it did not launch
(a program without K10)."""

import re

PATTERN = r'\bosc_decay_kernel\b'
COUNTER = 'oscillator_decay'


def read(trace):
    seconds, events = 0.0, 0
    for name, (s, n) in trace.device.items():
        if re.search(PATTERN, name):
            seconds += s
            events += n
    launches = trace.launches.get(COUNTER, 0)
    if events != launches:
        raise RuntimeError(f"the profiler recorded {events} events of "
                           f"{COUNTER} against {launches} counted launches")
    least = trace.bounds.get('oscillator_skip')
    if not launches or not seconds or least is None:
        return None
    return 100.0 * least / seconds
