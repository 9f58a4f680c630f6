"""Streaming synthesis (chunked render with carried state), JAX package vs
port, on the CPU.

The pieces the streamer adds (the oscillator phase carry, GRU final
states, the stateful layer list), one chunk, and whole files through
both drivers, for a v2-like model (FiLM context, deep mono network, FDN
reverb: an IR longer than a chunk) and a dafx22-like one (ContextNetwork
and MonophonicNetwork with Normalize layers, so the whole-file statistics
sweep runs), at small widths (4 voices, GRUs of at most 96 units, 2 s at
125-frame chunks) as tests/test_streaming.py builds them. Both packages
get the same parameters through params.load_jax_params; the port gets the
JAX streamer's own per-chunk noise draws. The JAX streamer runs op by op
outside its GRU scans (_EagerJax).
Then the port against itself (streamed against one-shot, chunk 125
against 250) and the CLI.
"""

import os

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ddsp_piano_torch import nn as tnn  # noqa: E402
from ddsp_piano_torch.models.streaming import (  # noqa: E402
    StreamingSynthesizer)
from ddsp_piano_torch.ops import oscillator as tosc  # noqa: E402
from ddsp_piano_torch.params import load_jax_params  # noqa: E402
from ddsp_piano_tpu import nn as jnn  # noqa: E402
from ddsp_piano_tpu.ops import oscillator as josc  # noqa: E402

DEMO_MIDI = os.path.join(os.path.dirname(__file__), '..', 'examples',
                         'demo.mid')
N_SYNTHS = 4
SAMPLE_RATE = 16000
FRAME_RATE = 250
N_FRAMES = 500
CHUNK = 125
# Whole files against the JAX streamer: the whole render's tolerance,
# 1.1e-4 of peak (ROADMAP C.2; the floor is JAX's float32 phase cumsum).
RENDER_TOL = 1.1e-4
# Streamed against one-shot, and one chunk length against another:
# tests/test_streaming.py:93-98 (0.02 of peak, correlation 0.999).
STREAM_TOL = 0.02
STREAM_MIN_CORR = 0.999


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _phase_gap(got, want):
    """Largest difference of two phases, mod 2 pi, in radians."""
    d = np.mod(np.asarray(got, np.float64) - np.asarray(want, np.float64),
               2 * np.pi)
    return float(np.minimum(d, 2 * np.pi - d).max())


# -- the oscillator's phase carry ------------------------------------------


@pytest.mark.parametrize('lookahead', [False, True])
@pytest.mark.parametrize('carry', [False, True], ids=['zero', 'carried'])
def test_osc_controls_with_phase_carry_match_jax(lookahead, carry):
    """framewise_osc_controls with initial_phase and lookahead, and
    framewise_final_phase: the crossfade endpoints exactly, the phases
    within 2e-5 rad mod 2 pi (JAX sums them in float32, the port in
    float64)."""
    rng = np.random.RandomState(3 + 2 * lookahead + carry)
    b, n, k, up = 3, 12, 10, 64
    f = rng.uniform(20.0, 7000.0, (b, n, k)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (b, n, k)).astype(np.float32)
    phase = (rng.uniform(0.0, 2 * np.pi, (b, 1, k)).astype(np.float32)
             if carry else None)
    want = josc.framewise_osc_controls(
        jnp.asarray(f), jnp.asarray(a), up, SAMPLE_RATE,
        initial_phase=None if phase is None else jnp.asarray(phase),
        lookahead=lookahead)
    initial = None if phase is None else _t(phase).double()
    got = tosc.framewise_osc_controls(_t(f), _t(a), up, SAMPLE_RATE,
                                      initial_phase=initial,
                                      lookahead=lookahead)
    assert got.f_lo.shape == (b, n - lookahead, k)
    for name in ('f_lo', 'f_hi', 'a_lo', 'a_hi'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.phase0.dtype == torch.float32
    assert _phase_gap(got.phase0.numpy(), want.phase0) <= 2e-5
    final = tosc.framewise_final_phase(got, up, SAMPLE_RATE,
                                       initial_phase=initial)
    assert final.dtype == torch.float64 and final.shape == (b, 1, k)
    assert _phase_gap(final.numpy(), josc.framewise_final_phase(
        want, up, SAMPLE_RATE)) <= 2e-5


def test_chunked_phases_equal_one_shot_phases():
    """Three chunks with the float64 carry and one frame of lookahead give
    the one-shot phases to float32 rounding, and the same endpoints."""
    rng = np.random.RandomState(0)
    f = _t(rng.uniform(20.0, 7000.0, (2, 301, 6)))
    a = _t(rng.uniform(0.0, 1.0, (2, 301, 6)))
    one = tosc.framewise_osc_controls(f[:, :300], a[:, :300], 64,
                                      SAMPLE_RATE)
    carry, parts = None, []
    for start in (0, 100, 200):
        c = tosc.framewise_osc_controls(f[:, start:start + 101],
                                        a[:, start:start + 101], 64,
                                        SAMPLE_RATE, initial_phase=carry,
                                        lookahead=True)
        carry = tosc.framewise_final_phase(c, 64, SAMPLE_RATE,
                                           initial_phase=carry)
        parts.append(c)
    got = tosc.FramewiseOscControls(*(torch.cat(p, dim=1)
                                      for p in zip(*parts)))
    for name in ('f_lo', 'a_lo'):
        torch.testing.assert_close(getattr(got, name), getattr(one, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(got.f_hi[:, :-1], one.f_hi[:, :-1], rtol=0,
                               atol=0)
    assert _phase_gap(got.phase0.numpy(), one.phase0.numpy()) <= 5e-7


# -- GRU states and the stateful layer list -----------------------------------


def test_gru_return_state_matches_jax():
    j = jnn.GRU(24, 8)
    params = j.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    x = rng.randn(3, 17, 8).astype(np.float32)
    h0 = (0.5 * rng.randn(3, 24)).astype(np.float32)
    want, want_h = j(params, jnp.asarray(x), initial_state=jnp.asarray(h0),
                     return_state=True)
    t = tnn.GRU(24, 8)
    load_jax_params(t, _np_tree(params))
    with torch.no_grad():
        got, got_h = t(_t(x), initial_state=_t(h0), return_state=True)
        plain = t(_t(x), initial_state=_t(h0))
    # 1e-5 absolute: tests/test_ctrl_kernels.py:100-108.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5)
    torch.testing.assert_close(got_h, got[:, -1], rtol=0, atol=0)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def _layer_list():
    """Dense -> GRU -> Dense -> Normalize, dafx22's mono layer list at
    small widths, in both packages with the same parameters."""
    j = jnn.Sequential([jnn.Dense(16, 6, activation='leaky_relu'),
                        jnn.GRU(20, 16),
                        jnn.Dense(12, 20, activation='leaky_relu'),
                        jnn.Normalize(12)])
    params = j.init(jax.random.PRNGKey(2))
    t = torch.nn.Sequential(tnn.Dense(16, 6, activation='leaky_relu'),
                            tnn.GRU(20, 16),
                            tnn.Dense(12, 20, activation='leaky_relu'),
                            tnn.Normalize(12))
    load_jax_params(t, _np_tree(params))
    return j, params, t


@pytest.mark.parametrize('mode', ['fixed_stats', 'stop_after'])
def test_apply_stream_matches_jax(mode):
    """apply_stream with a carried GRU state: with the Normalize slot's
    statistics fixed, the output and the states; with stop_after, the
    captured Normalize input and the states up to it (1e-5 absolute)."""
    j, params, t = _layer_list()
    rng = np.random.RandomState(4)
    x = rng.randn(2, 30, 6).astype(np.float32)
    h0 = (0.3 * rng.randn(2, 20)).astype(np.float32)
    mean = rng.randn(2, 1, 1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, (2, 1, 1)).astype(np.float32)
    kwargs = ({'norm_stats': {3: (mean, var)}} if mode == 'fixed_stats'
              else {'stop_after': 3})
    states = [None, h0, None, None]
    want, want_states, want_pre = j.apply_stream(
        params, jnp.asarray(x), [None if s is None else jnp.asarray(s)
                                 for s in states],
        **{k: ({3: tuple(jnp.asarray(v) for v in kv[3])}
               if k == 'norm_stats' else kv) for k, kv in kwargs.items()})
    with torch.no_grad():
        got, got_states, got_pre = tnn.apply_stream(
            t, _t(x), [None if s is None else _t(s) for s in states],
            **{k: ({3: tuple(_t(v) for v in kv[3])}
                   if k == 'norm_stats' else kv)
               for k, kv in kwargs.items()})
    assert [s is None for s in got_states] == [s is None
                                                for s in want_states]
    np.testing.assert_allclose(got_states[1].numpy(),
                               np.asarray(want_states[1]), atol=1e-5)
    assert sorted(got_pre) == sorted(want_pre)
    for i in want_pre:
        np.testing.assert_allclose(got_pre[i].numpy(),
                                   np.asarray(want_pre[i]), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if mode == 'fixed_stats':
        with torch.no_grad():
            out, out_states = tnn.apply_with_state(
                t, _t(x), [None, _t(h0), None, None],
                norm_stats={3: (_t(mean), _t(var))})
        torch.testing.assert_close(out, got, rtol=0, atol=0)
        torch.testing.assert_close(out_states[1], got_states[1], rtol=0,
                                   atol=0)


def test_normalize_with_whole_file_stats_equals_normalize():
    """Normalize.apply_with_stats at the sequence's own statistics is the
    layer itself."""
    layer = tnn.Normalize(5)
    tnn.init_weights(layer, 0)
    with torch.no_grad():
        layer.scale.mul_(1.5)
        layer.shift.add_(0.25)
        x = torch.randn(3, 40, 5, generator=torch.Generator().manual_seed(1))
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = torch.square(x - mean).mean(dim=(1, 2), keepdim=True)
        torch.testing.assert_close(layer.apply_with_stats(x, mean, var),
                                   layer(x), rtol=0, atol=0)
    assert layer.features == 5


# -- models -------------------------------------------------------------------


def _v2_like(pkg):
    """FiLM context (GRU 32) + deep mono network (GRU 48) + the v2 joint
    tuning + the per-instrument FDN reverb (a 2 s IR: its tail outlasts
    every chunk), audible noise."""
    if pkg == 'jax':
        from ddsp_piano_tpu import processors
        from ddsp_piano_tpu.configs.maestro_v2 import V2_TUNING_WEIGHTS
        from ddsp_piano_tpu.models import (PianoModel, Parallelizer,
                                           VectorizedPolyphonicProcessorGroup)
        from ddsp_piano_tpu.models import sub_modules as sm
    else:
        from ddsp_piano_torch import processors
        from ddsp_piano_torch.configs.maestro_v2 import V2_TUNING_WEIGHTS
        from ddsp_piano_torch.models import (
            PianoModel, Parallelizer, VectorizedPolyphonicProcessorGroup)
        from ddsp_piano_torch.models import sub_modules as sm
    group = VectorizedPolyphonicProcessorGroup(
        additive=processors.MultiInharmonic(frame_rate=FRAME_RATE,
                                            sample_rate=SAMPLE_RATE),
        noise=processors.DynamicSizeFilteredNoise(frame_rate=FRAME_RATE,
                                                  sample_rate=SAMPLE_RATE),
        reverb=processors.Reverb(),
        n_synths=N_SYNTHS)
    return PianoModel(
        note_release=sm.NoteRelease(frame_rate=FRAME_RATE),
        context_network=sm.FiLMContextNetwork(
            n_instruments=4, n_synths=N_SYNTHS, layer_dim=32,
            context_dim=16),
        parallelizer=Parallelizer(
            n_synths=N_SYNTHS,
            global_keys=('conditioning', 'context', 'piano_model')),
        monophonic_network=sm.MonophonicDeepNetwork(
            rnn_channels=48, ch=24, layers_per_stack=2, context_dim=16,
            output_splits=(('amplitudes', 1), ('harmonic_distribution', 12),
                           ('magnitudes', 13))),
        inharm_model=sm.JointParametricInharmTuning(
            n_instruments=4, pretrained_weights={
                k: v[:4] for k, v in V2_TUNING_WEIGHTS.items()}),
        reverb_model=sm.MultiInstrumentFeedbackDelayReverb(
            n_instruments=4, sample_rate=SAMPLE_RATE),
        processor_group=group)


def _dafx22_like(pkg):
    """dafx22's layer lists at small widths, with both Normalize layers
    (context slot 2, mono slot 3), the z encoder, inharmonicity network,
    two-substring detuner and a learned 0.25 s reverb IR."""
    if pkg == 'jax':
        from ddsp_piano_tpu import nn, processors
        from ddsp_piano_tpu.models import (PianoModel, Parallelizer,
                                           VectorizedPolyphonicProcessorGroup)
        from ddsp_piano_tpu.models import sub_modules as sm
    else:
        from ddsp_piano_torch import nn, processors
        from ddsp_piano_torch.models import (
            PianoModel, Parallelizer, VectorizedPolyphonicProcessorGroup)
        from ddsp_piano_torch.models import sub_modules as sm
    z_dim = 16
    group = VectorizedPolyphonicProcessorGroup(
        additive=processors.MultiInharmonic(frame_rate=FRAME_RATE,
                                            sample_rate=SAMPLE_RATE),
        noise=processors.DynamicSizeFilteredNoise(frame_rate=FRAME_RATE,
                                                  sample_rate=SAMPLE_RATE),
        reverb=processors.Reverb(),
        n_synths=N_SYNTHS)
    return PianoModel(
        z_encoder=sm.OneHotZEncoder(n_instruments=4, z_dim=z_dim,
                                    duration=N_FRAMES / FRAME_RATE,
                                    frame_rate=FRAME_RATE),
        note_release=sm.NoteRelease(frame_rate=FRAME_RATE),
        context_network=sm.ContextNetwork(
            layers=[nn.Dense(32, N_SYNTHS * 2 + 4 + z_dim,
                             activation='leaky_relu'),
                    nn.GRU(64, 32), nn.Normalize(64)],
            out_features=64),
        parallelizer=Parallelizer(n_synths=N_SYNTHS),
        monophonic_network=sm.MonophonicNetwork(
            layers=[nn.Dense(64, 35, activation='leaky_relu'),
                    nn.GRU(96, 64),
                    nn.Dense(96, 96, activation='leaky_relu'),
                    nn.Normalize(96)],
            out_features=96,
            output_splits=(('amplitudes', 1), ('harmonic_distribution', 16),
                           ('magnitudes', 17))),
        inharm_model=sm.InharmonicityNetwork(),
        detuner=sm.Detuner(n_substrings=2, use_detune=True),
        reverb_model=sm.MultiInstrumentReverb(
            n_instruments=4, reverb_duration=0.25, sample_rate=SAMPLE_RATE),
        processor_group=group)


MODELS = {'v2': _v2_like, 'dafx22': _dafx22_like}


def _conditioning(n_frames=N_FRAMES):
    """A note across chunk boundaries, a short one inside chunk 2
    (tests/test_streaming.py:67-80), a third voice released at a chunk
    boundary, pedal moves and piano 2."""
    cond = np.zeros((1, n_frames, N_SYNTHS, 2), np.float32)
    cond[:, 20:n_frames - 120, 0, 0] = 60.0
    cond[:, 20:28, 0, 1] = 0.8
    cond[:, 300:340, 1, 0] = 67.0
    cond[:, 300:308, 1, 1] = 0.6
    cond[:, 90:250, 2, 0] = 43.0
    cond[:, 90:98, 2, 1] = 0.7
    pedal = np.zeros((1, n_frames, 4), np.float32)
    pedal[:, 100:400, 0] = 0.8
    return {'conditioning': cond, 'pedal': pedal,
            'piano_model': np.array([[2]], np.int32)}


def _torch_features(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


@pytest.fixture(scope='module')
def models():
    """{name: (jax model, jax params, port model)}."""
    out = {}
    for name, build in MODELS.items():
        jmodel = build('jax')
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(5))
        model = build('torch')
        load_jax_params(model, _np_tree(params))
        out[name] = (jmodel, params, model.eval())
    return out


def _recording_noise(jmodel, draws):
    """Record every noise draw the JAX streamer makes, in order."""
    noise = jmodel.processor_group.noise
    original = noise._noise

    def record(rng, batch, n_samples):
        x = original(rng, batch, n_samples)
        if not isinstance(x, jax.core.Tracer):    # eval_shape's is no draw
            draws.append(torch.from_numpy(np.array(x)))
        return x

    noise._noise = record
    return lambda: setattr(noise, '_noise', original)


def _python_scan(body, carry, xs):
    """lax.scan as a python loop over the leading axis."""
    ys = []
    for i in range(jax.tree.leaves(xs)[0].shape[0]):
        carry, y = body(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


class _EagerJax:
    """The ``jax`` name of the JAX streaming module with its jit and its
    chunk scan run op by op, as tests/test_torch_render.py runs the JAX
    render: jitted, XLA contracts the tuning's multiply-adds and moves
    partial frequencies by an ulp. (jax.disable_jit would also unroll the
    jnp helpers, whose own jitted rounding the port copies, such as the
    float32 harmonic numbers of jnp.linspace.) The GRU scans inside stay
    compiled: their outputs carry no phase."""

    lax = type('lax', (), {'scan': staticmethod(_python_scan)})

    @staticmethod
    def jit(fn, **_):
        return fn

    def __getattr__(self, name):
        return getattr(jax, name)


class _Float64PhaseOscillator:
    """The ``oscillator`` name of the JAX streaming module with its phase
    sums widened to float64, as the port takes them (ROADMAP C.2): JAX's
    framewise_osc_controls and framewise_final_phase, each sum in float64
    and rounded once to float32. Abstract tracing (eval_shape) gets JAX's
    own functions."""

    @staticmethod
    def _increments(c, up, sample_rate):
        inc = (2 * np.pi / sample_rate) * (
            up * c.f_lo + (c.f_hi - c.f_lo) * ((up - 1.0) / 2.0))
        return np.mod(np.asarray(inc), 2 * np.pi).astype(np.float64)

    @classmethod
    def framewise_osc_controls(cls, f, a, up, sample_rate,
                               initial_phase=None, lookahead=False):
        c = josc.framewise_osc_controls(f, a, up, sample_rate,
                                        initial_phase=initial_phase,
                                        lookahead=lookahead)
        if isinstance(f, jax.core.Tracer):
            return c
        inc = cls._increments(c, up, sample_rate)
        phase = np.cumsum(inc, axis=1) - inc
        if initial_phase is not None:
            phase = phase + np.asarray(initial_phase, np.float64)
        return c._replace(phase0=jnp.asarray(
            np.mod(phase, 2 * np.pi).astype(np.float32)))

    @classmethod
    def framewise_final_phase(cls, c, up, sample_rate):
        if isinstance(c.f_lo, jax.core.Tracer):
            return josc.framewise_final_phase(c, up, sample_rate)
        last = np.asarray(c.phase0[:, -1:], np.float64) + cls._increments(
            c, up, sample_rate)[:, -1:]
        return jnp.asarray(np.mod(last, 2 * np.pi).astype(np.float32))

    def __getattr__(self, name):
        return getattr(josc, name)


def _jax_streamer_class(monkeypatch, phase_sums):
    """The JAX StreamingSynthesizer run op by op, with its phase sums in
    float64 or as they are ('float32')."""
    from ddsp_piano_tpu.models import streaming as jstreaming

    monkeypatch.setattr(jstreaming, 'jax', _EagerJax())
    if phase_sums == 'float64':
        monkeypatch.setattr(jstreaming, 'oscillator',
                            _Float64PhaseOscillator())
    return jstreaming.StreamingSynthesizer


def _jax_stream(js_class, jmodel, params, feats, driver):
    """The JAX streamer's render (audio, dry) and its per-chunk draws."""
    draws = []
    restore = _recording_noise(jmodel, draws)
    try:
        out = getattr(js_class(jmodel, chunk_frames=CHUNK), driver)(
            params, {k: jnp.asarray(v) for k, v in feats.items()},
            rng=jax.random.PRNGKey(11), return_dry=True)
    finally:
        restore()
    return tuple(np.asarray(x)[0] for x in out), draws


@pytest.mark.parametrize('driver', ['synthesize', 'synthesize_scanned'])
@pytest.mark.parametrize('phase_sums,name', [('float64', 'v2'),
                                             ('float64', 'dafx22'),
                                             ('float32', 'v2')])
def test_streamed_render_matches_jax(models, monkeypatch, phase_sums, name,
                                     driver):
    """Both drivers, JAX's per-chunk draws injected: wet and dry within
    the whole render's tolerance of the JAX streamer's, whose phase sums
    run in float64 (measured 1.0e-6 of peak v2, 1.7e-6 dafx22) or, for
    the v2 model, as they are (measured 6.3e-5). As they are, the dafx22
    model's 32 partials over 500 frames put the JAX streamer's float32
    phase floor at 1.5e-4 of peak (ROADMAP C.2): the port's gap to it."""
    js_class = _jax_streamer_class(monkeypatch, phase_sums)
    jmodel, params, model = models[name]
    (want, want_dry), draws = _jax_stream(js_class, jmodel, params,
                                          _conditioning(), driver)
    assert len(draws) == N_FRAMES // CHUNK + 1      # the flush's last
    streamer = StreamingSynthesizer(model, chunk_frames=CHUNK)
    assert streamer._norm_slots == ([] if name == 'v2'
                                    else [('context', 2), ('mono', 3)])
    with torch.inference_mode():
        got, got_dry = getattr(streamer, driver)(
            _torch_features(_conditioning()), noise=draws, return_dry=True)
    assert got.shape == (1, N_FRAMES * SAMPLE_RATE // FRAME_RATE)
    for stem, g, w in (('wet', got[0].numpy(), want),
                       ('dry', got_dry[0].numpy(), want_dry)):
        peak = np.abs(w).max()
        assert peak > 1e-2, (stem, peak)
        err = np.abs(g - w).max() / peak
        assert err <= RENDER_TOL, (stem, err)


def _tree_close(got, want, path=''):
    """Every leaf of a port state against the JAX state's (1e-5 of the
    leaf's peak; phases mod 2 pi, 2e-5 rad)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_close(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_close(g, w, f'{path}.{i}')
    elif want is None:
        assert got is None, path
    else:
        g, w = got.numpy(), np.asarray(want)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if path.endswith('osc_phase'):
            assert _phase_gap(g, w) <= 2e-5, path
        else:
            assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                      1e-30), path


@pytest.mark.parametrize('name', list(MODELS))
def test_chunk_forward_matches_jax(models, monkeypatch, name):
    """Two chunks of the python-loop protocol (the first without a carry,
    the second with the first's state), JAX's draws injected and its phase
    sums in float64: every state leaf and the audio."""
    jmodel, params, model = models[name]
    feats = _conditioning()
    jstreamer = _jax_streamer_class(monkeypatch, 'float64')(
        jmodel, chunk_frames=CHUNK)
    streamer = StreamingSynthesizer(model, chunk_frames=CHUNK)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    tfeats = _torch_features(feats)
    draws = []
    restore = _recording_noise(jmodel, draws)
    jstate, tstate = {}, {}
    try:
        with torch.inference_mode():
            jstatic = jstreamer._static_features(params, jfeats)
            tstatic = streamer._static_features(tfeats)
            if streamer._norm_slots:
                jstatic['_norm_stats'] = jstreamer._norm_stats_all(
                    params, jfeats, N_FRAMES // CHUNK)
                tstatic['_norm_stats'] = streamer._norm_stats_all(
                    tfeats, N_FRAMES // CHUNK)
                _tree_close(tstatic['_norm_stats'], jstatic['_norm_stats'])
            for i in range(2):
                sl = slice(i * CHUNK, (i + 1) * CHUNK)
                (jaudio, jdry), jstate = jstreamer._chunk_forward(
                    params, {'conditioning': jfeats['conditioning'][:, sl],
                             'pedal': jfeats['pedal'][:, sl],
                             'piano_model': jfeats['piano_model'],
                             **jstatic}, jstate, jax.random.PRNGKey(i))
                (audio, dry), tstate = streamer._chunk_forward(
                    {'conditioning': tfeats['conditioning'][:, sl],
                     'pedal': tfeats['pedal'][:, sl],
                     'piano_model': tfeats['piano_model'], **tstatic},
                    tstate, draws[i])
                _tree_close(tstate, jstate)
                for g, w in ((audio, jaudio), (dry, jdry)):
                    w = np.asarray(w)
                    assert g.shape == w.shape
                    err = np.abs(g.numpy() - w).max() / np.abs(w).max()
                    assert err <= RENDER_TOL, (i, err)
    finally:
        restore()


@pytest.mark.parametrize('name', list(MODELS))
def test_zero_state_has_the_carried_state_shapes(models, name):
    """_zero_state reads every shape from the modules; a chunk's new state
    has the same structure, shapes and dtypes."""
    _, _, model = models[name]
    streamer = StreamingSynthesizer(model, chunk_frames=CHUNK)
    feats = _torch_features(_conditioning())
    with torch.inference_mode():
        total, static = streamer._prepare(feats)
        zero = streamer._zero_state(feats, static)
        assert zero.pop('first') is True
        _, state = streamer._chunk_forward(
            streamer._chunk_features(feats, static, 0), dict(zero, first=True))

    def same(a, b, path=''):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                same(a[k], b[k], f'{path}.{k}')
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f'{path}.{i}')
        elif b is None:
            assert a is None, path
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert not a.any(), path

    same(zero, state)


# -- the port against itself --------------------------------------------------


def _full_draw(model, n_frames=N_FRAMES, seed=0):
    up = model.sample_rate // model.frame_rate
    return 2.0 * torch.rand((N_SYNTHS, n_frames * up),
                            generator=torch.Generator().manual_seed(seed)
                            ) - 1.0


def _assert_stream_close(got, want, up):
    """tests/test_streaming.py:93-98: all but the flushed last frame."""
    a, b = want[0, :-up].numpy(), got[0, :-up].numpy()
    scale = max(np.abs(a).max(), 1e-6)
    err = np.abs(b - a).max() / scale
    assert err <= STREAM_TOL, err
    assert np.corrcoef(a, b)[0, 1] > STREAM_MIN_CORR
    return err


@pytest.mark.parametrize('driver', ['synthesize', 'synthesize_scanned'])
@pytest.mark.parametrize('name', list(MODELS))
def test_streamed_matches_one_shot(models, name, driver):
    """Streamed against the one-shot forward on one full-length draw (the
    noise filter's chunk edges are the only difference: measured ~1e-4 of
    peak for v2-like, ~2e-3 for dafx22-like)."""
    _, _, model = models[name]
    feats = _torch_features(_conditioning())
    noise = _full_draw(model)
    with torch.inference_mode():
        one = model(feats, noise=noise)
        streamer = StreamingSynthesizer(model, chunk_frames=CHUNK)
        wet, dry = getattr(streamer, driver)(feats, noise=noise,
                                             return_dry=True)
    up = model.sample_rate // model.frame_rate
    assert wet.shape == one['audio_synth'].shape
    _assert_stream_close(wet, one['audio_synth'], up)
    _assert_stream_close(dry, one['add']['signal'], up)


@pytest.mark.parametrize('name', list(MODELS))
def test_chunk_length_invariance(models, name):
    _, _, model = models[name]
    feats = _torch_features(_conditioning())
    noise = _full_draw(model)
    with torch.inference_mode():
        s1 = StreamingSynthesizer(model, 125).synthesize(feats, noise=noise)
        s2 = StreamingSynthesizer(model, 250).synthesize(feats, noise=noise)
    _assert_stream_close(s1, s2, model.sample_rate // model.frame_rate)


def test_release_rings_across_chunks(models):
    """The long note ends at frame 380, inside chunk 3; its release
    (1.1 s) keeps sounding in chunk 4 (tests/test_streaming.py:102-113)."""
    _, _, model = models['v2']
    with torch.inference_mode():
        dry = StreamingSynthesizer(model, CHUNK).synthesize(
            _torch_features(_conditioning()), noise=_full_draw(model) * 0.0,
            return_dry=True)[1]
    post = dry[0, int(1.6 * SAMPLE_RATE):int(1.9 * SAMPLE_RATE)]
    assert post.abs().max() > 1e-3


def test_streaming_refuses_what_it_cannot_render(models):
    _, _, model = models['v2']
    streamer = StreamingSynthesizer(model, chunk_frames=120)
    with pytest.raises(ValueError, match='divisible by chunk_frames'):
        streamer.synthesize(_torch_features(_conditioning()))
    with pytest.raises(ValueError, match='chunk_frames'):
        StreamingSynthesizer(model, chunk_frames=0)
    group = model.processor_group
    try:
        model.processor_group = torch.nn.Identity()
        with pytest.raises(ValueError, match='vectorized polyphonic'):
            StreamingSynthesizer(model)
    finally:
        model.processor_group = group


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize('config', ['maestro_v2', 'dafx22'])
def test_streaming_cli_on_cpu(tmp_path, monkeypatch, config):
    """--streaming --device cpu -d 1 --chunk_seconds 0.4: 1.5 s of frames
    with the warm-up, padded to 4 chunks of 100; the audio is the file's
    length, finite, and the dry stem is written."""
    from ddsp_piano_torch import configs
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.data import audio_io

    real_get_model = configs.get_model
    monkeypatch.setattr(configs, 'get_model', lambda *a, **kw: real_get_model(
        *a, n_harmonics=16, n_noise_bands=17, **kw))
    out = str(tmp_path / 'demo.wav')
    result = cli.main(cli.process_args(
        ['-c', config, '--streaming', '--chunk_seconds', '0.4', '-d', '1',
         '-u', '--device', 'cpu', DEMO_MIDI, out]))
    sr = result['sample_rate']
    assert result['chunks'] == 4
    assert result['audio'].shape == result['dry'].shape == (sr,)
    assert np.isfinite(result['audio']).all()
    assert np.sqrt(np.mean(result['dry'] ** 2)) > 1e-4
    data, rate = audio_io.read_wav(out + '_unreverbed.wav')
    assert rate == sr and data.shape == (sr, 1)
    assert audio_io.read_wav(out)[0].shape == (sr, 1)
