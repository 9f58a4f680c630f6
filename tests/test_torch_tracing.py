"""The port's spans (ddsp_piano_torch.tracing), on the CPU.

- The span tree of serve calls and of training steps: names, parents and
  the units their spans share, each span inside its parent.
- Off, a serve and a step record no span, make no CUDA event and open no
  profiler range.
- A span and a record_function range inside it, under torch.profiler,
  fall on one clock.
- The Trainer's timeline keeps its four points a step (CUDA events
  stood in for by stamps of what the step had done when each was
  recorded), in and out of a process group of one rank, and step_times
  and reduce_times read them as before.
- A span opened in another thread has no parent in this one's.
- The idle split and the launch count on hand-made intervals with known
  answers.
Models at 4 voices and 0.2 s.
"""

import threading
import time

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
threadpoolctl.threadpool_limits(1)

from ddsp_piano_torch import tracing  # noqa: E402
from ddsp_piano_torch.configs import get_model  # noqa: E402
from ddsp_piano_torch.data.pipeline import get_dummy_data  # noqa: E402
from ddsp_piano_torch.models.serving import make_serving_fn  # noqa: E402
from ddsp_piano_torch.parallel import mesh  # noqa: E402
from ddsp_piano_torch.training import trainer as trainer_module  # noqa: E402
from ddsp_piano_torch.training.trainer import Trainer  # noqa: E402

SECONDS = 0.2
N_SYNTHS = 4


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    yield
    tracing.disable()


@pytest.fixture(scope='module')
def serve_inputs():
    model = get_model('maestro_v2', inference=True, device='cpu',
                      duration=SECONDS, n_synths=N_SYNTHS)
    roll = np.zeros((1, 50, 88, 2), np.float32)
    roll[0, 5:40, 40, 0] = 1.0
    roll[0, 5, 40, 1] = 0.6
    roll[0, 12:30, 47, 0] = 1.0
    roll[0, 12, 47, 1] = 0.4
    return (make_serving_fn(model), roll, np.zeros((1, 50, 4), np.float32),
            np.array([[2]], np.int32))


@pytest.fixture(scope='module')
def train_model():
    return get_model('maestro_v2', device='cpu', duration=SECONDS,
                     n_synths=N_SYNTHS, first_phase=True)


def _batches(n):
    return [get_dummy_data(batch_size=2, duration=SECONDS,
                           sample_rate=24000, n_synths=N_SYNTHS, seed=i)
            for i in range(n)]


def _check_nesting(spans):
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns
            assert s.end_ns <= s.parent.end_ns
            assert s.unit == s.parent.unit


def _tree(spans):
    return [(s.name, s.parent.name if s.parent else None, s.unit)
            for s in spans]


def test_serve_span_tree(serve_inputs):
    serve, roll, pedal, piano_model = serve_inputs
    recorder = tracing.enable()
    for _ in range(2):
        serve(roll, pedal, piano_model)
    assert tracing.disable() is recorder
    spans = recorder.spans
    _check_nesting(spans)
    requests = recorder.named('serve.request')
    assert len(requests) == 2
    assert requests[1].unit == requests[0].unit + 1
    for request in requests:
        mine = [s for s in spans if s.unit == request.unit]
        # In the order they ended.
        assert _tree(mine) == [
            ('serve.upload', 'serve.request', request.unit),
            ('serve.allocate', 'serve.request', request.unit),
            ('model.networks', 'model.forward', request.unit),
            ('model.synthesis', 'model.forward', request.unit),
            ('model.forward', 'serve.request', request.unit),
            ('serve.request', None, request.unit)]


@pytest.mark.parametrize('k', [1, 2])
def test_train_span_tree(train_model, k):
    """One unit a step (train_step) or a block (train_steps), numbered by
    its first step; each batch's staging joins the unit it feeds."""
    trainer = Trainer(train_model, first_phase=True)
    batches = _batches(2 * k)
    if k == 1:
        feed, step_fn = trainer.device_prefetch(iter(batches),
                                                packed=True), \
            trainer.train_step
    else:
        feed, step_fn = trainer.block_prefetch(iter(batches), k,
                                               packed=True), \
            trainer.train_steps
    recorder = tracing.enable()
    for _ in range(2):
        step_fn(next(feed))
    tracing.disable()
    spans = recorder.spans
    _check_nesting(spans)
    roots = recorder.named('train.step')
    assert [s.unit for s in roots] == [0, k]
    forward = [('model.networks', 'model.forward'),
               ('model.synthesis', 'model.forward'),
               ('model.losses', 'model.forward'),
               ('model.forward', 'train.forward'),
               ('train.forward', 'train.step'),
               ('train.backward', 'train.step'),
               ('train.update', 'train.step')]
    for root in roots:
        mine = [(name, parent) for name, parent, unit in _tree(spans)
                if unit == root.unit]
        assert mine == ([('train.stage', None),
                         ('train.update', 'train.step')] + forward * k
                        + [('train.update', 'train.step'),
                           ('train.step', None)])
        stage = [s for s in spans if s.unit == root.unit
                 and s.name == 'train.stage']
        assert stage[0].end_ns <= root.start_ns


def test_tracing_off_records_nothing(serve_inputs, train_model,
                                     monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("made while tracing is off")

    monkeypatch.setattr(tracing, '_device_event', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(tracing, 'Span', refuse)
    assert not tracing.enabled()
    assert tracing.span('serve.request', unit=3) is tracing._NULL
    serve, roll, pedal, piano_model = serve_inputs
    serve(roll, pedal, piano_model)
    trainer = Trainer(train_model, first_phase=True)
    trainer.train_step(next(trainer.device_prefetch(iter(_batches(1)),
                                                    packed=True)))
    assert trainer.timeline is None and trainer.step_times() == []


def test_span_and_profiler_share_a_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recorder = tracing.enable()
        with tracing.span('outer') as outer:
            with record_function('inner'):
                for _ in range(20):
                    x = torch.tanh(x @ x)
            time.sleep(0.002)
        tracing.disable()
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()}
    inner = events['inner']
    # The span's own record_function range too.
    assert 'outer' in events
    assert recorder.spans == [outer]
    assert outer.start_ns - 1_000_000 <= inner.start_ns()
    assert inner.end_ns() <= outer.end_ns + 1_000_000
    assert abs(events['outer'].start_ns() - outer.start_ns) < 1_000_000


class _Stamp:
    """A stand-in for a CUDA event: records how much of the step had
    happened (the log's length) and a clock in ms."""

    log = None

    def __init__(self):
        self.mark = None

    def record(self):
        self.mark = len(self.log)
        self.ms = 10.0 * self.mark

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _logged_trainer(model, monkeypatch):
    """A Trainer whose timeline takes stamped events, logging the step's
    stages as they happen."""
    log = []
    monkeypatch.setattr(_Stamp, 'log', log)
    monkeypatch.setattr(tracing, '_device_event', _Stamp)
    trainer = Trainer(model, first_phase=True, record_timeline=True)
    assert trainer.timeline == []            # no events off a card
    trainer._timeline = tracing.Recorder(device_events=True)

    def logged(name, fn):
        def call(*args, **kwargs):
            log.append(name + '<')
            out = fn(*args, **kwargs)
            log.append(name + '>')
            return out
        return call

    for name in ('_snapshot', '_as_device_batch', 'apply_gradients',
                 '_guard'):
        monkeypatch.setattr(trainer, name, logged(name,
                                                  getattr(trainer, name)))
    monkeypatch.setattr(trainer.model, 'forward',
                        logged('forward', trainer.model.forward))
    monkeypatch.setattr(trainer_module.dist, 'all_reduce',
                        logged('reduce', trainer_module.dist.all_reduce))
    monkeypatch.setattr(torch.Tensor, 'backward',
                        logged('backward', torch.Tensor.backward))
    return trainer, log


@pytest.mark.parametrize('group', [False, True],
                         ids=['one_process', 'one_rank_group'])
def test_timeline_keeps_its_points(train_model, monkeypatch, tmp_path,
                                   group):
    if group:
        mesh.init_rank(0, 1, mesh.Hosts(), 'cpu',
                       'file://' + str(tmp_path / 'rendezvous'))
    try:
        trainer, log = _logged_trainer(train_model, monkeypatch)
        for batch in _batches(2):
            trainer.train_step(batch)
        timeline, times = trainer.timeline, trainer.step_times()
        reduces = trainer.reduce_times()
    finally:
        mesh.end_rank()
    assert len(timeline) == len(times) == 2
    ends = [i for i, entry in enumerate(log) if entry == '_guard>']
    for k, (e, t) in enumerate(zip(timeline, times)):
        first = ends[k - 1] + 1 if k else 0
        step = log[first:ends[k] + 1]
        at = lambda entry: first + step.index(entry)     # noqa: E731
        # Start: after the snapshot, before the batch onto the device.
        assert at('_snapshot>') < e[0].mark == at('_as_device_batch<')
        # After the forward, before the backward.
        assert at('forward>') < e[1].mark == at('backward<')
        # After the backward (and, in a group, before the reduce).
        assert at('backward>') < e[2].mark
        assert e[2].mark <= at('reduce<' if group else 'apply_gradients<')
        # After the clip and Adam, before the NaN guard.
        assert at('apply_gradients>') < e[3].mark == at('_guard<')
        assert t == (e[0].elapsed_time(e[3]), e[0].elapsed_time(e[1]),
                     e[1].elapsed_time(e[2]), e[2].elapsed_time(e[3]))
    if group:
        spans = trainer._timeline.named('train.reduce')
        assert len(reduces) == len(spans) == 2
        for s, ms in zip(spans, reduces):
            assert log[s.events[0].mark] == 'reduce<'
            assert log[s.events[1].mark - 1] == 'reduce>'
            assert ms == s.events[0].elapsed_time(s.events[1])
    else:
        assert reduces == []


def test_spans_of_another_thread_have_their_own_parents():
    def load():
        with tracing.span('kernels.load'):
            pass

    recorder = tracing.enable()
    with tracing.span('main', unit=1):
        with tracing.span('other'):
            pass
        worker = threading.Thread(target=load)
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    tracing.disable()
    by_name = {s.name: s for s in recorder.spans}
    assert by_name['other'].parent is by_name['main']
    assert by_name['other'].unit == 1
    assert by_name['kernels.load'].parent is None
    assert by_name['kernels.load'].unit is None


# -- reading spans against a profile ------------------------------------------


def _span(name, start, end, parent=None, unit=None):
    s = tracing.Span(name, parent, unit)
    s.start_ns, s.end_ns = start, end
    return s


def _spans():
    """A step 0-100 (ns): a stage before it (-20 to -5), in it an update
    0-10, a forward 10-60 holding a model forward 20-50, a backward
    60-90; the caller's time after 100."""
    step = _span('train.step', 0, 100, unit=0)
    forward = _span('train.forward', 10, 60, step, 0)
    return [_span('train.stage', -20, -5, unit=0),
            _span('train.update', 0, 10, step, 0),
            _span('model.forward', 20, 50, forward, 0), forward,
            _span('train.backward', 60, 90, step, 0), step]


@pytest.mark.parametrize('busy, want', [
    # Idle all through: each span its own stretch, the caller the rest.
    ([], {'caller': 45, 'train.stage': 15, 'train.update': 10,
          'train.forward': 20, 'model.forward': 30, 'train.backward': 30,
          'train.step': 10}),
    # One gap from 5 to 70 crosses the update, the forward (its own
    # stretch and its child's) and the backward.
    ([(-30, 5), (70, 130)], {'train.update': 5, 'train.forward': 20,
                             'model.forward': 30, 'train.backward': 10}),
    # Overlapping device intervals; a gap 55-65 splits between the forward
    # and the backward, one 95-120 between the step and the caller.
    ([(-30, 50), (40, 55), (65, 95), (120, 130)],
     {'train.forward': 5, 'train.backward': 5, 'train.step': 5,
      'caller': 20}),
])
def test_idle_by_span(busy, want):
    got = tracing.idle_by_span(_spans(), busy, (-30, 130))
    assert {k: round(v * 1e9, 6) for k, v in got.items()} == want
    idle = 160 - sum(b - a for a, b in tracing._union(busy, -30, 130))
    assert sum(got.values()) * 1e9 == pytest.approx(idle)


def test_idle_between_sibling_spans_splits_at_their_boundary():
    root = _span('serve.request', 0, 100, unit=0)
    spans = [_span('serve.upload', 0, 40, root, 0),
             _span('serve.allocate', 40, 70, root, 0), root]
    got = tracing.idle_by_span(spans, [(0, 30), (60, 100)], (0, 100))
    assert {k: round(v * 1e9, 6) for k, v in got.items()} == {
        'serve.upload': 10, 'serve.allocate': 20}


class _Event:
    def __init__(self, name, start, end, device):
        self._name, self._start, self._end = name, start, end
        self._device = device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return self._name.startswith('train.')


class _Profile:
    """What profile_activity reads of a torch.profiler run."""

    def __init__(self, events):
        results = type('Results', (), {'events': lambda _: events})()
        self.profiler = type('Profiler', (), {'kineto_results': results})()


def test_profile_activity_and_launches_inside_spans():
    events = [_Event('cudaLaunchKernel', 12, 13, False),
              _Event('cudaLaunchKernelExC', 61, 62, False),
              _Event('cuLaunchKernel', 95, 96, False),
              _Event('cudaMemcpyAsync', 30, 31, False),
              _Event('cudaStreamSynchronize', 40, 45, False),
              _Event('aten::mul', 11, 14, False),
              _Event('cudaLaunchKernel', -10, -9, False),
              _Event('cudaLaunchKernel', 120, 121, False),
              _Event('gemm', 20, 50, True),
              _Event('train.step', 0, 100, True)]
    busy, launches = tracing.profile_activity(_Profile(events))
    assert busy == [(20, 50)]
    assert sorted(launches) == [-10, 12, 61, 95, 120]
    spans = _spans()
    assert tracing.inside(spans, launches, ['train.step']) == (3, 5)
    assert tracing.inside(spans, launches,
                          ['train.step', 'train.stage']) == (4, 5)
