"""The modules only ``.gin`` models reach, and the ``.gin`` reader: the
JAX package vs the port, on the CPU.

Each function gets numpy inputs from a seed, through the JAX function and
the port's, with the tolerance of the JAX package's own test of it
(tests/test_core_ops.py, test_oscillator.py, test_filters_spectral.py,
test_processors.py) unless stated. Losses also hold their gradient
against jax.grad. Then one gin text, written here at small widths, goes
through the JAX build_from_gin and the port's get_model(path.gin): the
same parameter names and shapes, and a 0.5 s render within 1.1e-4 of
peak (ROADMAP C.2) from the same params, through the folded-voice group
and the sequential per-voice DAG. Randomness is injected: the JAX noise
draws and loop shifts are computed here from its keys and handed to the
port.
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

from ddsp_piano_torch import processors as tproc  # noqa: E402
from ddsp_piano_torch.configs import gin_compat as tgin  # noqa: E402
from ddsp_piano_torch.models import losses as tlosses  # noqa: E402
from ddsp_piano_torch.models import sub_modules as tsm  # noqa: E402
from ddsp_piano_torch.ops import core as tcore  # noqa: E402
from ddsp_piano_torch.ops import filters as tfilters  # noqa: E402
from ddsp_piano_torch.ops import oscillator as tosc  # noqa: E402
from ddsp_piano_torch.ops import spectral as tspec  # noqa: E402
from ddsp_piano_torch.params import (export_jax_params,  # noqa: E402
                                     flatten_tree, load_jax_params)
from ddsp_piano_tpu import processors as jproc  # noqa: E402
from ddsp_piano_tpu.configs import gin_compat as jgin  # noqa: E402
from ddsp_piano_tpu.models import losses as jlosses  # noqa: E402
from ddsp_piano_tpu.models import sub_modules as jsm  # noqa: E402
from ddsp_piano_tpu.ops import core as jcore  # noqa: E402
from ddsp_piano_tpu.ops import filters as jfilters  # noqa: E402
from ddsp_piano_tpu.ops import oscillator as josc  # noqa: E402
from ddsp_piano_tpu.ops import spectral as jspec  # noqa: E402

# The render tolerance (ROADMAP C.2).
RENDER_TOL = 1.1e-4


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x)


def _peak_err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- ops/core.py -------------------------------------------------------------


def test_core_conversions_match_jax():
    rs = np.random.RandomState(0)
    hz = np.concatenate([rs.uniform(20.0, 8000.0, 64), [0.0, -3.0, 440.0]])
    hz = hz.astype(np.float32)
    # rtol 1e-6: log2 of two libraries may differ in the last place.
    np.testing.assert_allclose(tcore.hz_to_midi(_t(hz)).numpy(),
                               np.asarray(jcore.hz_to_midi(hz)), rtol=1e-6)
    unit = rs.uniform(-0.5, 1.5, (3, 7)).astype(np.float32)
    midi = rs.uniform(0.0, 127.0, (3, 7)).astype(np.float32)
    for clip in (False, True):
        np.testing.assert_allclose(
            tcore.unit_to_midi(_t(unit), clip=clip).numpy(),
            np.asarray(jcore.unit_to_midi(jnp.asarray(unit), clip=clip)),
            rtol=1e-6)
        np.testing.assert_allclose(
            tcore.midi_to_unit(_t(midi), 10.0, 100.0, clip=clip).numpy(),
            np.asarray(jcore.midi_to_unit(midi, 10.0, 100.0, clip=clip)),
            rtol=1e-6)
    for x in (None, 3, [1, 2], (4,), 'a'):
        assert tcore.make_iterable(x) == jcore.make_iterable(x)


@pytest.mark.parametrize('length,chunk', [(2500, 1000), (640, 1000),
                                          (3000, 250)])
def test_angular_cumsum_matches_jax(length, chunk):
    rs = np.random.RandomState(1)
    w = rs.uniform(0.0, 0.6, (2, length, 3)).astype(np.float32)
    got = tcore.angular_cumsum(_t(w), chunk_size=chunk).numpy()
    want = np.asarray(jcore.angular_cumsum(jnp.asarray(w), chunk_size=chunk))
    # Both sum in float32 in the same order; the phases wrap at 2 pi, so
    # compare them on the circle (test_core_ops: atol 1e-3).
    diff = np.angle(np.exp(1j * (got.astype(np.float64) - want)))
    assert np.abs(diff).max() < 1e-3


def test_pad_or_trim_and_cross_fade_match_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 100).astype(np.float32)
    for n, value in ((90, 0.0), (110, -1.0), (100, 0.0)):
        np.testing.assert_array_equal(
            tcore.pad_or_trim_to_expected_length(_t(x), n, value).numpy(),
            np.asarray(jcore.pad_or_trim_to_expected_length(
                jnp.asarray(x), n, value)))
    with pytest.raises(ValueError):
        tcore.pad_or_trim_to_expected_length(_t(x), 200)
    a = rs.randn(2, 50).astype(np.float32)
    b = rs.randn(2, 70).astype(np.float32)
    for n in (None, 0, 16, 33):
        np.testing.assert_allclose(
            tcore.cross_fade(_t(a), _t(b), n).numpy(),
            np.asarray(jcore.cross_fade(jnp.asarray(a), jnp.asarray(b), n)),
            rtol=1e-6, atol=1e-6)


# -- ops/oscillator.py and InHarmonic.get_signal -----------------------------


def _harmonic_controls(b=2, n_frames=50, n_harm=8, seed=2):
    rs = np.random.RandomState(seed)
    f0 = rs.rand(b, n_frames, 1).astype(np.float32) * 2000.0 + 50.0
    amps = rs.rand(b, n_frames, 1).astype(np.float32)
    dist = rs.rand(b, n_frames, n_harm).astype(np.float32)
    dist /= dist.sum(-1, keepdims=True)
    shifts = (rs.rand(b, n_frames, n_harm) * 1e-2).astype(np.float32)
    return f0, amps, dist, shifts


@pytest.mark.parametrize('angular', [False, True],
                         ids=['cumsum', 'angular_cumsum'])
def test_oscillator_bank_envelopes_matches_jax(angular):
    """The envelope pipeline at 8 kHz partials and above Nyquist; the
    port's phase sums in float64, JAX's in float32: held at
    test_oscillator.py's rtol 1e-3, atol 2e-3."""
    rs = np.random.RandomState(3)
    n = 3200
    freqs = np.cumsum(rs.uniform(20.0, 40.0, (2, n, 6)), axis=1) / 10.0
    freqs[..., -1] = 8100.0
    freqs = freqs.astype(np.float32)
    amps = rs.rand(2, n, 6).astype(np.float32)
    got = tosc.oscillator_bank_envelopes(_t(freqs), _t(amps), 16000,
                                         use_angular_cumsum=angular)
    want = josc.oscillator_bank_envelopes(freqs, amps, 16000,
                                          use_angular_cumsum=angular)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-3)
    per = tosc.oscillator_bank_envelopes(_t(freqs), _t(amps), 16000,
                                         sum_sinusoids=False)
    assert per.shape == (2, n, 6)
    assert float(per[..., -1].abs().max()) == 0.0


@pytest.mark.parametrize('method', ['framewise', 'envelopes'])
def test_harmonic_synthesis_matches_jax(method):
    f0, amps, dist, shifts = _harmonic_controls()
    kwargs = dict(harmonic_shifts=shifts, harmonic_distribution=dist,
                  n_samples=50 * 64, sample_rate=16000, method=method,
                  return_final_phase=True)
    got, got_phase = tosc.harmonic_synthesis(
        _t(f0), _t(amps), **{k: _t(v) if isinstance(v, np.ndarray) else v
                             for k, v in kwargs.items()})
    want, want_phase = josc.harmonic_synthesis(f0, amps, **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-3)
    diff = np.angle(np.exp(1j * (got_phase.numpy() - np.asarray(want_phase))))
    assert np.abs(diff).max() < 1e-3


def test_inharmonic_get_signal_matches_jax():
    """InHarmonic's controls and render (inharm.py:101-112): through the
    framewise front door on the CPU, the plain oscillator."""
    f0, amps, dist, _ = _harmonic_controls(n_frames=40, n_harm=12, seed=4)
    inharm = np.full((2, 40, 1), 2e-4, np.float32)
    tsynth = tproc.InHarmonic(frame_rate=250, sample_rate=16000)
    jsynth = jproc.InHarmonic(frame_rate=250, sample_rate=16000)
    got = tsynth(_t(amps), _t(dist), _t(inharm), _t(f0))
    want = jax.jit(lambda *a: jsynth({}, *a))(amps, dist, inharm, f0)
    assert got.shape == (2, 40 * 64)
    assert _peak_err(got, want) <= RENDER_TOL


# -- ops/filters.py -----------------------------------------------------------


@pytest.mark.parametrize('window_size', [0, 33, 64, 65])
@pytest.mark.parametrize('causal', [False, True])
def test_apply_window_to_impulse_response_matches_jax(window_size, causal):
    ir = np.random.RandomState(5).randn(2, 3, 64).astype(np.float32)
    got = tfilters.apply_window_to_impulse_response(_t(ir), window_size,
                                                    causal)
    want = jfilters.apply_window_to_impulse_response(ir, window_size, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('method', ['fft', 'conv', 'linmap', 'auto'])
@pytest.mark.parametrize('n_frames', [1, 10])
def test_frequency_filter_methods_match_jax(method, n_frames):
    """Each method against the JAX function's same method, at
    test_filters_spectral.py:193-209's atol 1e-5 (of an O(1) output)."""
    rs = np.random.RandomState(6)
    audio = rs.uniform(-1.0, 1.0, (2, 640)).astype(np.float32)
    mags = rs.rand(2, n_frames, 33).astype(np.float32)
    for window_size in (0, 31):
        got = tfilters.frequency_filter(_t(audio), _t(mags), window_size,
                                        method=method)
        want = jfilters.frequency_filter(audio, mags, window_size,
                                         method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5)
    with pytest.raises(ValueError):
        tfilters.frequency_filter(_t(audio), _t(mags), method='nope')


# -- ops/spectral.py ----------------------------------------------------------


def _audio_pair(n=4000, seed=7):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    target = (0.5 * np.sin(2 * np.pi * 440.0 * t)[None]
              + 0.05 * rs.randn(2, n)).astype(np.float32)
    synth = (0.3 * np.sin(2 * np.pi * 445.0 * t)[None]
             + 0.05 * rs.randn(2, n)).astype(np.float32)
    return target, synth


@pytest.mark.parametrize('loss_type', ['L1', 'L2', 'COSINE'])
def test_mean_difference_matches_jax(loss_type):
    rs = np.random.RandomState(8)
    a = rs.randn(3, 5, 7).astype(np.float32)
    b = rs.randn(3, 5, 7).astype(np.float32)
    b[0, 0, :3] = a[0, 0, :3]               # ties
    tb = _t(b).requires_grad_(True)
    got = tspec.mean_difference(_t(a), tb, loss_type)
    got.backward()
    got = got.detach()
    want, want_grad = jax.value_and_grad(
        lambda v: jspec.mean_difference(jnp.asarray(a), v, loss_type))(
            jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-9)
    per = tspec.mean_difference(_t(a), _t(b), loss_type, per_element=True)
    for i in range(3):
        np.testing.assert_allclose(
            float(per[i]), float(jspec.mean_difference(
                a[i:i + 1], b[i:i + 1], loss_type)), rtol=1e-5)


def test_loudness_matches_jax():
    """A-weighting and compute_loudness (spectral.py:175-207) in float32:
    the dB within 1e-4 (5e-6 relative at the ~20 dB scale), ref_db and
    the range floor included."""
    freqs = np.linspace(0.0, 12000.0, 1025).astype(np.float32)
    np.testing.assert_allclose(
        tspec._a_weighting_db(_t(freqs)).numpy(),
        np.asarray(jax.jit(jspec._a_weighting_db)(freqs)), rtol=1e-5,
        atol=1e-4)
    target, _ = _audio_pair()
    quiet = target.copy()
    quiet[1] = 0.0
    for kwargs in ({}, dict(sample_rate=24000, ref_db=20.7),
                   dict(range_db=30.0, n_fft=1024)):
        got = tspec.compute_loudness(_t(quiet), **kwargs)
        want = jax.jit(lambda a: jspec.compute_loudness(a, **kwargs))(quiet)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    one = tspec.compute_loudness(_t(target[0]))
    assert one.shape == jspec.compute_loudness(target[0]).shape


TERMS = {'mag': dict(mag_weight=1.0),
         'logmag': dict(mag_weight=0.0, logmag_weight=1.0),
         'delta_time': dict(mag_weight=0.0, delta_time_weight=1.0),
         'delta_freq': dict(mag_weight=0.0, delta_freq_weight=1.0),
         'cumsum_freq': dict(mag_weight=0.0, cumsum_freq_weight=1.0),
         'loudness': dict(mag_weight=0.0, loudness_weight=1.0),
         'all_l2': dict(loss_type='L2', logmag_weight=1.0,
                        delta_time_weight=0.5, delta_freq_weight=0.5,
                        cumsum_freq_weight=0.1, loudness_weight=0.1)}


@pytest.mark.parametrize('term', sorted(TERMS))
def test_spectral_loss_terms_and_gradients_match_jax(term):
    """Each term of multi_scale_spectral_loss alone: its value within rtol
    1e-4 (test_torch_training's whole-step loss) and its gradient with
    respect to the synthesized audio within 1e-3 of the gradient's peak
    (the loss magnitudes' float32 FFTs differ by rounding)."""
    target, synth = _audio_pair()
    kwargs = dict(TERMS[term], fft_sizes=(512, 128), sample_rate=16000)
    ts = _t(synth).requires_grad_(True)
    got = tspec.multi_scale_spectral_loss(_t(target), ts, **kwargs)
    got.backward()
    got = got.detach()
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda s: jspec.multi_scale_spectral_loss(jnp.asarray(target), s,
                                                  **kwargs)))(
            jnp.asarray(synth))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    assert _peak_err(ts.grad, want_grad) <= 1e-3
    # One distance per element: each the loss of its singleton batch.
    per = tspec.multi_scale_spectral_loss(_t(target), _t(synth),
                                          per_element=True, **kwargs)
    one = tspec.multi_scale_spectral_loss(_t(target[1:]), _t(synth[1:]),
                                          **kwargs)
    np.testing.assert_allclose(float(per[1]), float(one), rtol=1e-5)


def test_cumsum_frequency_gradient_at_ties_matches_jax():
    """Built ties of the cumulative term (ROADMAP C.4): target and synth
    share their first 1024 samples, so the 128-point frames there are
    equal, their cumulative sums tie exactly, and the L1's gradient takes
    JAX's +1 at each tie. Held against jax.grad within 1e-5 of peak."""
    target, synth = _audio_pair(n=2048)
    synth[:, :1024] = target[:, :1024]
    kwargs = dict(fft_sizes=(128,), mag_weight=0.0, cumsum_freq_weight=1.0)
    ts = _t(synth).requires_grad_(True)
    tspec.multi_scale_spectral_loss(_t(target), ts, **kwargs).backward()
    want = jax.jit(jax.grad(lambda s: jspec.multi_scale_spectral_loss(
        jnp.asarray(target), s, **kwargs)))(jnp.asarray(synth))
    assert _peak_err(ts.grad, want) <= 1e-5


@pytest.mark.parametrize('size', [64, 256])
def test_compute_mag_mm_and_mel_match_jax(size):
    target, _ = _audio_pair(n=2000)
    got = tspec.compute_mag(_t(target), size=size, method='mm')
    want = jspec.compute_mag(target, size=size, method='mm')
    # test_filters_spectral.py:305-329: rtol 1e-4 of the peak.
    assert _peak_err(got, want) <= 1e-4
    fft = tspec.compute_mag(_t(target), size=size, method='fft')
    assert _peak_err(got, fft) <= 1e-4
    np.testing.assert_array_equal(
        tspec._linear_to_mel_matrix(16, size // 2 + 1, 16000, 0.0, 8000.0),
        jspec._linear_to_mel_matrix(16, size // 2 + 1, 16000, 0.0, 8000.0))
    mel = tspec.compute_mel(_t(target), bins=16, fft_size=size)
    want_mel = jspec.compute_mel(target, bins=16, fft_size=size)
    assert _peak_err(mel, want_mel) <= 1e-5


def test_loudness_and_reverb_losses_match_jax():
    target, synth = _audio_pair()
    ts = _t(synth).requires_grad_(True)
    outs = {'a': {'signal': _t(target)}, 'b': {'signal': ts}}
    got = tlosses.LoudnessLoss('a', 'b', sample_rate=16000).compute(outs)
    got.backward()
    got = got.detach()
    loss = jlosses.LoudnessLoss('a', 'b', sample_rate=16000)
    want, want_grad = jax.jit(jax.value_and_grad(lambda s: loss.compute(
        {'a': {'signal': jnp.asarray(target)}, 'b': {'signal': s}})))(
            jnp.asarray(synth))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    assert _peak_err(ts.grad, want_grad) <= 1e-3
    ir = np.random.RandomState(9).randn(2, 100).astype(np.float32)
    for loss_type in ('L1', 'L2'):
        np.testing.assert_allclose(
            float(tlosses.ReverbRegularizer(loss_type=loss_type).compute(
                {'reverb_ir': _t(ir)})),
            float(jlosses.ReverbRegularizer(loss_type=loss_type).compute(
                {'reverb_ir': jnp.asarray(ir)})), rtol=1e-6)


# -- processors: the adders, the DAG interpreter, the noise bands -------------


def test_trainable_reverb_matches_jax():
    """Reverb(trainable=True), which a gin file may bind: its IR a
    parameter of reverb_length samples, the signal against JAX's with the
    same IR (test_filters_spectral.py's FFT-convolution atol 1e-5)."""
    rs = np.random.RandomState(14)
    audio = rs.uniform(-1.0, 1.0, (2, 3000)).astype(np.float32)
    tverb = tproc.Reverb(trainable=True, reverb_length=400)
    jverb = jproc.Reverb(trainable=True, reverb_length=400)
    params = _load(tverb, jverb)
    assert tuple(tverb.ir.shape) == (400,)
    np.testing.assert_allclose(tverb(_t(audio)).detach().numpy(),
                               np.asarray(jverb(params, audio)), atol=1e-5)
    with pytest.raises(ValueError, match='trainable'):
        tproc.Reverb().get_controls(_t(audio))


def test_adders_and_nested_lookup_match_jax():
    rs = np.random.RandomState(10)
    sigs = [rs.randn(2, 8).astype(np.float32) for _ in range(3)]
    add = tproc.Add()
    np.testing.assert_array_equal(
        add(_t(sigs[0]), _t(sigs[1])).numpy(),
        np.asarray(jproc.Add()({}, sigs[0], sigs[1])))
    np.testing.assert_array_equal(
        tproc.MultiAdd()(*map(_t, sigs)).numpy(),
        np.asarray(jproc.MultiAdd()({}, *sigs)))
    tree = {'a': {'b': {'c': 3}}, 'x': 1}
    assert tproc.nested_lookup('a/b/c', tree) == 3
    with pytest.raises(KeyError, match='failed at'):
        tproc.nested_lookup('a/q', tree)


def _mono_feats(n_voices, b=1, t=10, n_harm=8, n_mags=33, seed=11):
    rs = np.random.RandomState(seed)
    feats = {}
    for i in range(n_voices):
        feats[f'amplitudes_{i}'] = rs.randn(b, t, 1).astype(np.float32)
        feats[f'harmonic_distribution_{i}'] = rs.randn(
            b, t, n_harm).astype(np.float32)
        feats[f'inharm_coef_{i}'] = np.full((b, t, 1), 1e-4, np.float32)
        feats[f'f0_hz_{i}'] = rs.uniform(100.0, 900.0,
                                         (b, t, 1)).astype(np.float32)
        feats[f'magnitudes_{i}'] = rs.randn(b, t, n_mags).astype(np.float32)
    return feats


def test_processor_group_matches_jax():
    """JAX's own two-voice DAG (tests/test_processors.py:163-178): an
    InHarmonic and a filtered-noise synth per voice, summed by MultiAdd
    and Add. The JAX group draws each noise node's noise from fold_in(key,
    node); the port is handed the same draws."""
    def dag(p):
        additive = p.InHarmonic(frame_rate=250, sample_rate=16000,
                                name='additive')
        noise = p.DynamicSizeFilteredNoise(frame_rate=250, sample_rate=16000,
                                           name='noise')
        add, add2 = p.MultiAdd(name='add'), p.Add(name='add2')
        keys = lambda i: [f'amplitudes_{i}', f'harmonic_distribution_{i}',
                          f'inharm_coef_{i}', f'f0_hz_{i}']
        return [(additive, keys(0)), (noise, ['magnitudes_0']),
                (add, ['noise/signal', 'additive/signal']),
                (additive, keys(1)), (noise, ['magnitudes_1']),
                (add, ['add/signal', 'noise/signal', 'additive/signal']),
                (add2, ['add/signal', 'additive/signal'])]

    feats = _mono_feats(2)
    key = jax.random.PRNGKey(0)
    want = jax.jit(lambda f: jproc.ProcessorGroup(dag(jproc))(
        {}, f, rng=key))({k: jnp.asarray(v) for k, v in feats.items()})
    draws = [np.asarray(jax.random.uniform(jax.random.fold_in(key, i),
                                           (1, 640), jnp.float32, -1.0, 1.0))
             for i in (1, 4)]
    group = tproc.ProcessorGroup(dag(tproc))
    got = group({k: _t(v) for k, v in feats.items()},
                noise=[_t(d) for d in draws])
    assert set(got['controls']) == set(want['controls'])
    for key_ in ('add', 'add2', 'noise', 'additive', 'out'):
        assert _peak_err(got['controls'][key_]['signal'],
                         want['controls'][key_]['signal']) <= RENDER_TOL
    assert _peak_err(got['signal'], want['signal']) <= RENDER_TOL
    # One tensor splits over the noise nodes as the list does.
    split = group({k: _t(v) for k, v in feats.items()},
                  noise=_t(np.concatenate(draws)))
    np.testing.assert_array_equal(split['signal'].numpy(),
                                  got['signal'].numpy())


def test_filterbank_and_noise_bands_match_jax():
    kwargs = dict(n_filters_linear=8, n_filters_log=8, sample_rate=16000)
    tfb, jfb = tproc.FilterBank(**kwargs), jproc.FilterBank(**kwargs)
    np.testing.assert_array_equal(tfb.band_centers, jfb.band_centers)
    assert len(tfb.filters) == len(jfb.filters) == 16
    for a, b in zip(tfb.filters, jfb.filters):
        np.testing.assert_array_equal(a, b)
    from ddsp_piano_tpu.processors.noise import get_noise_bands
    for normalize in (True, False):
        bands, n = tproc.get_noise_bands(tfb, 16, normalize)
        want, want_n = get_noise_bands(jfb, 16, normalize)
        assert n == want_n
        np.testing.assert_array_equal(bands, np.asarray(want))


@pytest.fixture(scope='module')
def band_synths():
    kwargs = dict(n_band=16, upsampling=64, sample_rate=16000,
                  min_noise_len=2 ** 4)
    return tproc.NoiseBandNetSynth(**kwargs), jproc.NoiseBandNetSynth(
        **kwargs)


@pytest.mark.parametrize('case', ['exact', 'remainder', 'short', 'loop'])
def test_noise_band_synth_matches_jax(band_synths, case):
    """The chunked resample at chunk boundaries, the stretched remainder
    chunk, a sequence shorter than one chunk, and a noise loop shorter
    than one frame (frame_len == 0); the JAX loop shift injected. Held at
    test_processors.py:291's atol 1e-5."""
    tsynth, jsynth = band_synths
    if case == 'loop':
        tsynth = tproc.NoiseBandNetSynth(n_band=16, upsampling=64,
                                         sample_rate=16000)
        tsynth.noise_len = 32
        tsynth.noise_bands = tsynth.noise_bands[:, :32]
        jsynth.noise_len, saved = 32, (jsynth.noise_len, jsynth.noise_bands)
        jsynth.noise_bands = jsynth.noise_bands[:, :32]
    frame_len = tsynth.noise_len // tsynth.upsampling
    n_frames = {'exact': frame_len * 3,
                'remainder': frame_len * 3 + frame_len // 2 + 1,
                'short': frame_len - 2, 'loop': 10}[case]
    n_bands = tsynth.noise_bands.shape[-1]
    amps = np.random.RandomState(12).rand(2, n_frames, n_bands).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    try:
        want = jsynth({}, amps, rng=key)
        shift = jax.random.randint(key, (), 0, jsynth.noise_bands.shape[1])
    finally:
        if case == 'loop':
            jsynth.noise_len, jsynth.noise_bands = saved
    got = tsynth(_t(amps), noise=int(shift))
    assert got.shape == (2, n_frames * 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    drawn = tsynth(_t(amps), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn).all()


def test_noise_band_synth_takes_a_draw_row_by_row(band_synths):
    """A (b, n_samples) uniform draw loops each row of bands from the shift
    its first value picks, as that row alone with the integer shift; any
    other noise= is refused."""
    tsynth, _ = band_synths
    n_frames, length = 40, tsynth.noise_bands.shape[1]
    amps = _t(np.random.RandomState(4).rand(3, n_frames,
                                            tsynth.noise_bands.shape[-1]))
    draw = 2.0 * torch.rand((3, n_frames * 64),
                            generator=torch.Generator().manual_seed(5)) - 1
    draw[:, 0] = torch.tensor([-1.0, 0.3, 1.0 - 1e-7])
    got = tsynth(amps, noise=draw)
    for row in range(3):
        shift = min(int((float(draw[row, 0]) + 1.0) / 2.0 * length),
                    length - 1)
        want = tsynth(amps[row:row + 1], noise=shift)
        torch.testing.assert_close(got[row:row + 1], want, rtol=0, atol=0)
    for bad in (torch.tensor([1, 2, 3]), torch.tensor(2.0), draw[:2],
                draw[:, 1:]):
        with pytest.raises(ValueError, match='loop shift'):
            tsynth(amps, noise=bad)


# -- models/sub_modules.py ----------------------------------------------------


def _load(port_module, jax_module, key=0):
    params = jax_module.init(jax.random.PRNGKey(key))
    load_jax_params(port_module, jax.tree.map(np.asarray, params))
    return params


def test_gin_sub_modules_match_jax():
    """BackgroundNoiseFilter (both modes), DeepInharmonicity (with and
    without global_inharm), DictDetuner (a non-zero table) and
    PartialMasking (set and passed), at tests/test_torch_configs.py's
    rtol 1e-5 for the frequency path and exact where JAX is exact."""
    rs = np.random.RandomState(13)
    piano = np.array([[2], [7]], np.int32)
    for denoise in (False, True):
        t_bg = tsm.BackgroundNoiseFilter(10, 8, duration=0.5,
                                         denoise=denoise)
        j_bg = jsm.BackgroundNoiseFilter(10, 8, duration=0.5,
                                         denoise=denoise)
        params = _load(t_bg, j_bg)
        np.testing.assert_allclose(
            t_bg(torch.from_numpy(piano)).detach().numpy(),
            np.asarray(jax.jit(j_bg.apply)(params, piano)), rtol=1e-6)
    pitch = np.tile(np.arange(21, 109, dtype=np.float32)[None, :, None],
                    (2, 1, 1))
    pitch[1, ::3] += 0.37
    gi = rs.randn(2, 88, 1).astype(np.float32) * 1e-4
    t_di, j_di = tsm.DeepInharmonicity(ch=8, n_layers=3), \
        jsm.DeepInharmonicity(ch=8, n_layers=3)
    params = _load(t_di, j_di)
    for g in (None, gi):
        got = t_di(_t(pitch), None if g is None else _t(g))
        want = jax.jit(j_di.apply)(params, jnp.asarray(pitch),
                                   None if g is None else jnp.asarray(g))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-12)
    t_dd, j_dd = tsm.DictDetuner(), jsm.DictDetuner()
    table = (rs.randn(128, 1) * 0.1).astype(np.float32)
    params = {'layer': {'embeddings': jnp.asarray(table)}}
    load_jax_params(t_dd, jax.tree.map(np.asarray, params))
    np.testing.assert_allclose(
        t_dd(_t(pitch)).detach().numpy(),
        np.asarray(j_dd(params, jnp.asarray(pitch))), rtol=1e-6)
    dist = rs.randn(3, 5, 12).astype(np.float32)
    for n in (None, 4):
        np.testing.assert_array_equal(
            tsm.PartialMasking(n)(_t(dist)).numpy(),
            np.asarray(jsm.PartialMasking(n)({}, jnp.asarray(dist))))


# -- the gin reader and builder -----------------------------------------------


_NOISE_SYNTHS = {
    'bands': """noise/NoiseBandNetSynth:
    name = 'noise'
    n_band = {n_band}
    upsampling = {upsampling}
    sample_rate = %sample_rate""",
    'filtered': """noise/DynamicSizeFilteredNoise:
    name = 'noise'
    frame_rate = %frame_rate
    sample_rate = %sample_rate"""}


def gin_text(sample_rate=16000, n_synths=4, layer_dim=16, context_dim=8,
             rnn_channels=32, ch=16, n_harmonics=16, n_band=16, duration=0.5,
             n_partials=12, noise='bands'):
    """A polyphonic model that reaches every gin-only module: the FiLM
    context, NoteRelease, DeepInharmonicity + DictDetuner, the background
    noise filter, partial masking, MultiInharmonic and NoiseBandNetSynth
    (or, with noise='filtered', the filtered noise) through
    polyphonic_dag, the v2 FDN reverb, the spectral loss with delta and
    loudness terms and the loudness loss."""
    synth = {'bands': 'NoiseBandNetSynth',
             'filtered': 'DynamicSizeFilteredNoise'}[noise]
    noise_block = _NOISE_SYNTHS[noise].format(
        n_band=n_band, upsampling=sample_rate // 250)
    return f'''# A polyphonic model reaching the gin-only modules.
import ddsp_piano

sample_rate = {sample_rate}
frame_rate = 250
n_synths = {n_synths}
n_instruments = 10
duration = {duration}
inference = False

get_model.model = @PianoModel()

PianoModel.note_release = @NoteRelease()
NoteRelease.frame_rate = %frame_rate

PianoModel.context_network = @FiLMContextNetwork()
FiLMContextNetwork:
    n_instruments = %n_instruments
    n_synths = %n_synths
    layer_dim = {layer_dim}
    context_dim = {context_dim}

PianoModel.background_noise_model = @BackgroundNoiseFilter()
BackgroundNoiseFilter:
    n_instruments = %n_instruments
    n_filters = {n_band}
    duration = %duration
    frame_rate = %frame_rate

PianoModel.parallelizer = @Parallelizer()
Parallelizer.n_synths = %n_synths
Parallelizer.global_keys = ('conditioning', 'context', 'piano_model')

PianoModel.inharm_model = @DeepInharmonicity()
DeepInharmonicity.ch = 32
DeepInharmonicity.n_layers = 4
PianoModel.detuner = @DictDetuner()

PianoModel.monophonic_network = @MonophonicDeepNetwork()
MonophonicDeepNetwork:
    rnn_channels = {rnn_channels}
    ch = {ch}
    layers_per_stack = 3
    context_dim = {context_dim}
    output_splits = (('amplitudes', 1),
                     ('harmonic_distribution', {n_harmonics}),
                     ('magnitudes', {n_band}))

PianoModel.harmonic_masking = @PartialMasking()
PartialMasking.n_partials = {n_partials}

PianoModel.reverb_model = @MultiInstrumentFeedbackDelayReverb()
MultiInstrumentFeedbackDelayReverb.n_instruments = %n_instruments
MultiInstrumentFeedbackDelayReverb.sample_rate = %sample_rate

PianoModel.processor_group = @ProcessorGroup()
ProcessorGroup.dag = @polyphonic_dag()
polyphonic_dag:
    additive = @additive/MultiInharmonic()
    noise = @noise/{synth}()
    reverb = @reverb/Reverb()
    additive_controls = ('amplitudes', 'harmonic_distribution',
                         'inharm_coef', 'f0_hz')
    noise_controls = ('magnitudes',)
    reverb_controls = ('reverb_ir',)
    n_synths = %n_synths
additive/MultiInharmonic:
    name = 'additive'
    frame_rate = %frame_rate
    sample_rate = %sample_rate
{noise_block}
reverb/Reverb.add_dry = True  # the dry mix is added back

PianoModel.losses = [@SpectralLoss(), @LoudnessLoss()]
SpectralLoss:
    loss_type = 'L1'
    mag_weight = 1.0
    logmag_weight = 1.0
    delta_time_weight = 0.1
    loudness_weight = 0.01
    name = 'audio_stft_loss'
LoudnessLoss:
    target_key = 'add'
    synth_key = 'reverb'
    sample_rate = %sample_rate
    name = 'loudness_loss'
'''


def write_gin(path, **widths):
    with open(path, 'w') as f:
        f.write(gin_text(**widths))
    return str(path)


def test_gin_parser_matches_jax():
    """The JAX package's parser cases (tests/test_gin_compat.py:20-56,
    113-125), and the gin text here parsed to the same macros and
    bindings by both readers."""
    for text in ("3", "2.5", "True", "None", "'abc'", "[1, 2, 3]",
                 "(('a', 1), ('b', 2))", "{'a': [1], 'b': %x}",
                 "@context_net/layers.GRU()", "@core.exp_sigmoid"):
        assert repr(tgin._ValueParser(text).parse()) == repr(
            jgin._ValueParser(text).parse())
    text = gin_text()
    got, want = tgin.parse_gin_string(text), jgin.parse_gin_string(text)
    assert repr(got.macros) == repr(want.macros)
    assert repr(got.bindings) == repr(want.bindings)
    cfg = tgin.GinConfig(macros={}, bindings={
        'Dense': {'': {'units': 1}, 'c': {'units': 64},
                  'b/c': {'units': 128}}})
    assert cfg.get('layers.Dense', scope='a/b/c')['units'] == 128
    assert cfg.get('layers.Dense', scope='x/c')['units'] == 64
    assert cfg.get('layers.Dense', scope='z')['units'] == 1
    with pytest.raises(ValueError):
        tgin.parse_gin_string("this is not gin")


def _conditioning(n_frames=125, n_synths=4):
    cond = np.zeros((1, n_frames, n_synths, 2), np.float32)
    for voice, (pitch, start) in enumerate([(43, 5), (59, 35), (62, 65),
                                            (67, 95)][:n_synths]):
        cond[:, start:, voice, 0] = pitch
        cond[:, start:start + 8, voice, 1] = 0.7
    return cond


@pytest.fixture(scope='module')
def gin_renders(tmp_path_factory):
    """The gin text built by both packages (0.5 s, 16 kHz, 4 voices), the
    port's seeded weights exported as the JAX params (the JAX init's
    structure from eval_shape: its own init takes seconds to compile), and
    a training render of each from the same features; the JAX side's loop
    shift injected into the port."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    path = write_gin(tmp_path_factory.mktemp('gin') / 'model.gin')
    jmodel = jax_get_model(path, duration=0.5)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    model = get_model(path, duration=0.5, device='cpu')
    params = export_jax_params(model)
    group = jmodel.processor_group
    pedal = np.zeros((1, 125, 4), np.float32)
    pedal[:, 60:, 0] = 0.8
    target = np.random.RandomState(13).uniform(-0.5, 0.5, (1, 8000))
    feats = {'conditioning': _conditioning(), 'pedal': pedal,
             'piano_model': np.array([[3]], np.int32),
             'audio': target.astype(np.float32)}
    rng = jax.random.PRNGKey(7)
    # Jitted: the tuning here is DictDetuner's midi_to_hz of a zero table
    # (no tanh), and the float32 phase sum sets the floor either way
    # (measured 1.2e-5 of peak jitted, 5.9e-6 op by op).
    jout = jax.jit(lambda p, f: jmodel(p, f, training=True, rng=rng))(
        params, {k: jnp.asarray(v) for k, v in feats.items()})
    shift = int(jax.random.randint(jax.random.fold_in(rng, 1), (), 0,
                                   group.noise.noise_bands.shape[1]))
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    with torch.no_grad():
        tout = model(tfeats, noise=shift, training=True)
        seq = model(tfeats, noise=shift, training=True,
                    use_sequential_dag=True)
    return dict(path=path, jmodel=jmodel, shapes=shapes, params=params,
                model=model, jout=jout, tout=tout, seq=seq, feats=feats,
                shift=shift)


def test_gin_build_matches_jax_parameters(gin_renders):
    """The port's parameters have the names and shapes of the JAX init's
    leaves, export_jax_params gives the JAX init's tree (the processor
    group's entries by name), load_jax_params takes it back into a model
    of another seed, the phase masks agree, and the TF name map is the JAX
    package's."""
    from ddsp_piano_tpu.training.checkpoints import tf_name_map as jax_map

    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.training.checkpoints import tf_name_map

    jmodel, shapes, params, model = (gin_renders[k] for k in (
        'jmodel', 'shapes', 'params', 'model'))
    leaves = dict(flatten_tree(shapes))
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(v.shape) for n, v in leaves.items()}
    assert sorted(params) == sorted(shapes)
    assert sorted(params['processor_group']) == sorted(
        shapes['processor_group'])
    assert {n: v.shape for n, v in flatten_tree(params)} == {
        n: tuple(v.shape) for n, v in leaves.items()}
    other = get_model(gin_renders['path'], duration=0.5, device='cpu',
                      seed=1)
    load_jax_params(other, params)
    for name, p in other.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      dict(flatten_tree(params))[name])
    for first_phase in (True, False, None):
        want = dict(flatten_tree(jax.tree.map(bool, jmodel.trainable_mask(
            params, first_phase=first_phase))))
        assert model.trainable_mask(first_phase) == want
    want_tf = {name: '.'.join([slot] + [str(p) for p in path])
               for name, (slot, path) in jax_map(jmodel, params).items()}
    assert tf_name_map(model) == want_tf
    for slot in ('background_noise_model', 'harmonic_masking',
                 'inharm_model', 'detuner'):
        assert getattr(model, slot) is not None


def test_gin_render_matches_jax(gin_renders):
    """Wet and dry audio within 1.1e-4 of peak, the controls of the new
    modules within rtol 1e-5 (the masked harmonic distribution within
    1e-5 of its peak), each loss within rtol 1e-4; the sequential
    DAG within 1.1e-4 of peak of the folded-voice group (the same noise
    shift in every voice node)."""
    jout, tout, seq = (gin_renders[k] for k in ('jout', 'tout', 'seq'))
    for got, want in ((tout['audio_synth'], jout['audio_synth']),
                      (tout['add']['signal'], jout['add']['signal'])):
        assert np.abs(np.asarray(want)).max() > 0.0
        assert _peak_err(got, want) <= RENDER_TOL
    for key in ('f0_hz', 'inharm_coef', 'background_mag'):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    # The masked network output: a GRU's rounding, held as the IRs are.
    assert _peak_err(tout['harmonic_distribution'],
                     jout['harmonic_distribution']) <= 1e-5
    assert float(tout['harmonic_distribution'][..., 12:].max()) == -10.0
    assert sorted(tout['losses']) == sorted(jout['losses'])
    for key, value in jout['losses'].items():
        np.testing.assert_allclose(float(tout['losses'][key]), float(value),
                                   rtol=1e-4, err_msg=key)
    for stem in ('audio_synth', 'add'):
        a = seq[stem] if stem == 'audio_synth' else seq[stem]['signal']
        b = tout[stem] if stem == 'audio_synth' else tout[stem]['signal']
        assert _peak_err(a, b) <= RENDER_TOL
    for name in ('additive', 'noise', 'reverb'):
        assert _peak_err(seq[name]['signal'], tout[name]['signal']) \
            <= RENDER_TOL


def test_sequential_dag_matches_jax(gin_renders):
    """The port's sequential group against the JAX sequential group on the
    same features: JAX's per-node keys give each voice its own loop
    shift, handed to the port as a list."""
    jmodel, params, model, feats = (gin_renders[k] for k in (
        'jmodel', 'params', 'model', 'feats'))
    rng = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, f: jmodel(p, f, rng=rng,
                                       use_sequential_dag=True))(
        params, {k: jnp.asarray(v) for k, v in feats.items()})
    group = jmodel.processor_group
    n_bands = group.noise.noise_bands.shape[1]
    shifts = [int(jax.random.randint(jax.random.fold_in(rng, 3 * i + 1), (),
                                     0, n_bands))
              for i in range(model.n_synths)]
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in feats.items()},
                    noise=shifts, use_sequential_dag=True)
    assert _peak_err(got['audio_synth'], want['audio_synth']) <= RENDER_TOL


def test_default_model_groups_match_jax():
    """build_polyphonic_processor_group in both forms (the same DAG
    nodes and names as JAX's), get_model's DAFx-22 model and build_model's
    shape check, on the CPU."""
    from ddsp_piano_torch.models import default_model as tdm
    from ddsp_piano_tpu.models import default_model as jdm

    vec = tdm.build_polyphonic_processor_group(n_synths=3)
    seq = tdm.build_polyphonic_processor_group(n_synths=3, vectorized=False)
    jseq = jdm.build_polyphonic_processor_group(n_synths=3, vectorized=False)
    shape = lambda dag: [(p.name, list(k)) for p, k in dag]
    assert shape(seq.dag) == shape(jseq.dag)
    assert shape(vec.as_sequential_group().dag) == shape(jseq.dag)
    model = tdm.build_model(tdm.get_model(duration=0.2, n_synths=2),
                            batch_size=1, duration=0.2, device='cpu')
    jmodel = jdm.get_model(duration=0.2, n_synths=2)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: v.shape for n, v in flatten_tree(jax.eval_shape(
            jmodel.init, jax.random.PRNGKey(0)))}


def test_gin_cli_paths(gin_renders, tmp_path):
    """A .gin path through get_model's registry (config_rates), the
    synthesize CLI and configs.gin_test."""
    from ddsp_piano_torch import synthesize_midi_file
    from ddsp_piano_torch.configs import config_rates, gin_test
    from ddsp_piano_torch.data import midi

    path = gin_renders['path']
    assert config_rates(path) == {'sample_rate': 16000, 'frame_rate': 250,
                                  'n_synths': 4}
    result = gin_test.main(gin_test.process_args(
        [path, '--device', 'cpu', '--duration', '0.5', '--batch_size', '1']))
    assert np.isfinite(result['step_losses']['total_loss'])
    assert result['audio_shape'] == (1, 8000)
    mid = str(tmp_path / 'two.mid')
    midi.write_midi(mid, [midi.Note(60, 90, 0.1, 0.4),
                          midi.Note(64, 80, 0.2, 0.5)], [])
    out = str(tmp_path / 'out.wav')
    synthesize_midi_file.main(synthesize_midi_file.process_args(
        ['-c', path, '--device', 'cpu', '-d', '0.6', mid, out]))
    assert os.path.getsize(out) > 44


def test_gin_evaluate_cli(gin_renders, tmp_path, monkeypatch):
    """evaluate_model -c <.gin> on the gin text's NoiseBandNetSynth model:
    each segment's row of the evaluation draw picks its loop shift, so
    the CSV is finite and does not depend on the batch size. The folded
    and sequential groups agree on such a draw."""
    import csv

    from ddsp_piano_torch import evaluate_model
    from ddsp_piano_torch.data import pipeline
    from test_torch_configs_cli import _eval_segments

    segs = _eval_segments(3, 16000, n_synths=4)
    monkeypatch.setattr(pipeline, 'get_test_dataset',
                        lambda *a, **k: iter(list(segs)))
    losses = []
    for batch_size in (1, 2):
        out_dir = str(tmp_path / f'b{batch_size}')
        result = evaluate_model.main(evaluate_model.process_args(
            ['-c', gin_renders['path'], '--duration', '0.5', '--batch_size',
             str(batch_size), '--device', 'cpu', 'data', out_dir]))
        assert result['batches'] == 4 - batch_size
        with open(os.path.join(out_dir, 'spectral.csv'), newline='') as f:
            rows = list(csv.DictReader(f))
        assert [r['filename'] for r in rows] == ['track_0', 'track_1',
                                                 'track_2']
        losses.append(np.array([float(r['loss_val']) for r in rows]))
    assert np.isfinite(losses[0]).all() and (losses[0] > 0).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)

    model, feats = gin_renders['model'], gin_renders['feats']
    draw = 2.0 * torch.rand((4, 8000),
                            generator=torch.Generator().manual_seed(1)) - 1
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    with torch.no_grad():
        folded = model(tfeats, noise=draw)['audio_synth']
        seq = model(tfeats, noise=draw, use_sequential_dag=True)
    assert _peak_err(seq['audio_synth'], folded) <= RENDER_TOL


def test_gin_model_streams_as_one_shot(tmp_path):
    """StreamingSynthesizer reads the background noise and partial masking
    slots as the JAX streamer does (streaming.py:213-215, :249-251): a
    gin model with both streams as the registered configs do
    (tests/test_torch_configs_cli.py): on one full-length draw within 0.02
    of peak and correlation 0.999 but the flushed frame; with the noise
    draw silent, within 1e-5 of peak beside each chunk boundary. (With the
    draw, the filtered noise's chunk-local FIR edges, which the streamer
    documents, reach 2-7e-5 of this model's peak there; silent, the gap is
    below 2e-7.) The filtered noise here: the noise bands, like JAX's,
    loop from a fresh shift and resample within each chunk."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.models.streaming import StreamingSynthesizer
    from test_torch_configs_cli import (BOUNDARY_TOL, CHUNK, STREAM_MIN_CORR,
                                        STREAM_TOL, _stream_features)

    path = write_gin(tmp_path / 'filtered.gin', noise='filtered',
                     duration=2.0)
    model = get_model(path, inference=True, duration=2.0, device='cpu')
    feats = _stream_features()
    up = model.sample_rate // model.frame_rate
    draw = 2.0 * torch.rand((4, 500 * up),
                            generator=torch.Generator().manual_seed(0)) - 1
    for noise in (draw, torch.zeros_like(draw)):
        with torch.inference_mode():
            one = model(feats, noise=noise)
            wet, dry = StreamingSynthesizer(model, CHUNK).synthesize(
                feats, noise=noise, return_dry=True)
        assert float(one['harmonic_distribution'][..., 12:].max()) == -10.0
        for got, want in ((wet, one['audio_synth']),
                          (dry, one['add']['signal'])):
            a, b = want[0, :-up].numpy(), got[0, :-up].numpy()
            peak = np.abs(a).max()
            assert peak > 1e-2
            assert np.abs(b - a).max() / peak <= STREAM_TOL
            assert np.corrcoef(a, b)[0, 1] > STREAM_MIN_CORR
            if noise is draw:
                continue
            for edge in range(CHUNK * up, 500 * up - up, CHUNK * up):
                window = slice(edge - up, edge + up)
                assert np.abs(b[window] - a[window]).max() / peak \
                    <= BOUNDARY_TOL, edge
