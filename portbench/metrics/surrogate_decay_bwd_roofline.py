"""Share of its roofline, %, of K11, the backward of the surrogate synth's
decaying-partial oscillator (kernels/oscillator_decay.py): its least time
at the sub-window's launches over its device time from the profiler. The
least time is the yardstick's K4 count of the same cells
(``bounds['oscillator_skip_bwd']``, from the reference's decay render's
controls): it leaves out the envelope's work, the two decay sums and
their bytes, so it is a lower bound. The profiler's events of K11 are held
to its launch counter here; None where it did not launch (a program
without K11)."""

import re

PATTERN = r'\bosc_decay_bwd_kernel\b'
COUNTER = 'oscillator_decay_bwd'


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
    least = trace.bounds.get('oscillator_skip_bwd')
    if not launches or not seconds or least is None:
        return None
    return 100.0 * least / seconds
