"""Spans at ddsp_piano_torch's layer boundaries, on torch.profiler's clock.

A span is a named interval of the host's time: a request served, a training
step, the staging of a batch, a model's forward and its parts, the build of
the kernels. Each records its name, start and end, the span it opened
inside (its parent) and its unit, the request or step it belongs to, which
its children share. Spans stay in memory, in the order they ended:

    recorder = tracing.enable()
    ...                             # serve, train
    tracing.disable()
    recorder.spans                  # [Span]

Off by default. Off, :func:`span` returns one shared null context: no
record, no CUDA event, no profiler range. On, while a torch.profiler runs,
each span also opens a ``torch.profiler.record_function`` range, so that
the profiler's trace shows it over the kernels (Perfetto,
chrome://tracing).

The clock: a span is stamped with ``time.time_ns()``, the clock of
torch.profiler's events. Kineto gives every event it records, the host's
operators and runtime calls and the device's kernels and copies, in Unix
nanoseconds (``prof.profiler.kineto_results.events()``, ``start_ns()`` and
``end_ns()``), so a span lays directly over the device's intervals of a
profile taken while it was open (:func:`profile_activity`). That profile
may record the device alone (``ProfilerActivity.CUDA``), which leaves the
host at close to its own pace: :func:`idle_by_span` then puts each
interval in which the card ran nothing down to the innermost span open on
the host at that instant.

A span may carry a pair of CUDA events, recorded where it opens and where
it closes: the Trainer's timeline (``Trainer(record_timeline=True)``) is
made of such spans, handed to its own :class:`Recorder` whether tracing is
on or not.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Runtime calls that launch a kernel or a CUDA graph (the training step's
# replays), as the profiler names them.
LAUNCH_CALLS = frozenset(('cudaLaunchKernel', 'cudaLaunchKernelExC',
                          'cudaLaunchCooperativeKernel', 'cuLaunchKernel',
                          'cuLaunchKernelEx', 'cudaGraphLaunch'))
CALLER = 'caller'


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (time.time_ns()),
    ``parent`` (the enclosing Span or None), ``unit`` (its request or step,
    or None) and ``events`` (its start and end CUDA events, or None)."""

    __slots__ = ('name', 'start_ns', 'end_ns', 'parent', 'unit', 'events')

    def __init__(self, name: str, parent: Optional['Span'], unit):
        self.name = name
        self.parent = parent
        self.unit = unit
        self.start_ns = self.end_ns = 0
        self.events = None


class Recorder:
    """Spans kept in memory, in the order they ended (children before
    their parent). ``device_events``: spans handed to it as ``into`` carry
    CUDA events (else they are not handed to it)."""

    def __init__(self, device_events: bool = False):
        self.spans: List[Span] = []
        self.device_events = device_events

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


_ACTIVE: Optional[Recorder] = None
_NULL = contextlib.nullcontext()
_LOCAL = threading.local()
# Whether a torch.profiler runs (a record_function range costs ~10 us of
# host time even when none does); set by enable().
_profiling = None


def enable() -> Recorder:
    """Turn tracing on with a fresh Recorder, and return it."""
    global _ACTIVE, _profiling
    import torch

    _profiling = torch._C._autograd._profiler_enabled
    _ACTIVE = Recorder()
    return _ACTIVE


def disable() -> Optional[Recorder]:
    """Turn tracing off; returns the Recorder that was recording."""
    global _ACTIVE
    recorder, _ACTIVE = _ACTIVE, None
    return recorder


def enabled() -> bool:
    return _ACTIVE is not None


def _device_event():
    import torch
    return torch.cuda.Event(enable_timing=True)


class _Open:
    """The context of one span."""

    __slots__ = ('name', 'unit', 'recorder', 'into', 'span', 'range')

    def __init__(self, name, unit, recorder, into):
        self.name, self.unit = name, unit
        self.recorder, self.into = recorder, into
        self.range = None

    def __enter__(self) -> Span:
        stack = getattr(_LOCAL, 'stack', None)
        if stack is None:
            stack = _LOCAL.stack = []
        parent = stack[-1] if stack else None
        unit = self.unit
        if unit is None and parent is not None:
            unit = parent.unit
        s = self.span = Span(self.name, parent, unit)
        if self.into is not None:
            s.events = (_device_event(), _device_event())
            s.events[0].record()
        if self.recorder is not None and _profiling():
            from torch.profiler import record_function
            self.range = record_function(self.name)
            self.range.__enter__()
        stack.append(s)
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.end_ns = time.time_ns()
        _LOCAL.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        if s.events is not None:
            s.events[1].record()
            self.into.spans.append(s)
        if self.recorder is not None:
            self.recorder.spans.append(s)
        return False


def span(name: str, unit=None, into: Optional[Recorder] = None):
    """A context manager that records the span ``name`` while tracing is
    on. ``unit`` starts a unit (a request's or a step's number); without
    it the span takes its parent's. ``into``, a Recorder with
    device_events, also takes the span, with its CUDA events, whether
    tracing is on or not."""
    if into is not None and not into.device_events:
        into = None
    if _ACTIVE is None and into is None:
        return _NULL
    return _Open(name, unit, _ACTIVE, into)


# -- reading spans against a profile ------------------------------------------


def profile_activity(prof) -> Tuple[List[Tuple[int, int]], List[int]]:
    """(the device's intervals [(start_ns, end_ns)], the start_ns of every
    kernel-launch runtime call) of a torch.profiler run, on the spans'
    clock."""
    from torch.autograd import DeviceType

    busy, launches = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                busy.append((ev.start_ns(), ev.end_ns()))
        elif ev.name() in LAUNCH_CALLS:
            launches.append(ev.start_ns())
    return busy, launches


def _union(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
           ) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if a >= b:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _depth(s: Span, memo: Dict[int, int]) -> int:
    if id(s) not in memo:
        memo[id(s)] = 0 if s.parent is None else 1 + _depth(s.parent, memo)
    return memo[id(s)]


def idle_by_span(spans: Sequence[Span], busy: Iterable[Tuple[int, int]],
                 window: Tuple[int, int]) -> Dict[str, float]:
    """Seconds of ``window`` (start_ns, end_ns) in which the card ran
    nothing, by the name of the innermost span open at each instant, or
    CALLER where none was. The values add up to the window's idle
    seconds."""
    lo, hi = window
    idle, t = [], lo
    for a, b in _union(busy, lo, hi):
        if a > t:
            idle.append((t, a))
        t = b
    if t < hi:
        idle.append((t, hi))
    starts = [a for a, _ in idle]
    before = [0]
    for a, b in idle:
        before.append(before[-1] + b - a)

    def idle_to(x: int) -> int:
        """Idle nanoseconds of the window before x."""
        i = bisect.bisect_right(starts, x)
        if i == 0:
            return 0
        a, b = idle[i - 1]
        return before[i - 1] + min(x, b) - a

    memo: Dict[int, int] = {}
    marks: Dict[int, List[Tuple[int, Span]]] = {}
    for s in spans:
        a, b = max(s.start_ns, lo), min(s.end_ns, hi)
        if a < b:
            marks.setdefault(a, []).append((1, s))
            marks.setdefault(b, []).append((-1, s))
    out: Dict[str, float] = {}
    open_spans: Dict[int, Span] = {}
    t = lo
    for x in sorted(marks) + [hi]:
        if x > t:
            inner = max(open_spans.values(),
                        key=lambda s: (_depth(s, memo), s.start_ns),
                        default=None)
            name = CALLER if inner is None else inner.name
            ns = idle_to(x) - idle_to(t)
            if ns:
                out[name] = out.get(name, 0.0) + ns * 1e-9
            t = x
        for sign, s in marks.get(x, ()):
            if sign > 0:
                open_spans[id(s)] = s
            else:
                open_spans.pop(id(s), None)
    return out


def inside(spans: Sequence[Span], stamps: Iterable[int],
           names: Iterable[str]) -> Tuple[int, int]:
    """(stamps that fall inside a span of one of ``names``, stamps)."""
    names = set(names)
    cover = _union(((s.start_ns, s.end_ns) for s in spans
                    if s.name in names), -(1 << 62), 1 << 62)
    starts = [a for a, _ in cover]
    hits = total = 0
    for x in stamps:
        total += 1
        i = bisect.bisect_right(starts, x)
        if i and x <= cover[i - 1][1]:
            hits += 1
    return hits, total
