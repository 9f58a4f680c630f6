"""The port's modules against the JAX package's, on the same inputs.

Small widths where the module takes them; JAX params come from the JAX
module's own init and reach the port through params.load_jax_params.
"""

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
from ddsp_piano_torch.models import sub_modules as tsm  # noqa: E402
from ddsp_piano_torch.ops import fdn as tfdn  # noqa: E402
from ddsp_piano_torch.ops import filters as tfilters  # noqa: E402
from ddsp_piano_torch.params import load_jax_params  # noqa: E402
from ddsp_piano_torch.processors import inharm as tinharm  # noqa: E402
from ddsp_piano_torch.processors import noise as tnoise  # noqa: E402
from ddsp_piano_tpu import nn as jnn  # noqa: E402
from ddsp_piano_tpu.models import sub_modules as jsm  # noqa: E402
from ddsp_piano_tpu.ops import fdn as jfdn  # noqa: E402
from ddsp_piano_tpu.ops import filters as jfilters  # noqa: E402
from ddsp_piano_tpu.processors import inharm as jinharm  # noqa: E402
from ddsp_piano_tpu.processors import noise as jnoise  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _close(got, want, rel, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: max error {err:.3g} of peak > {rel:g}"


# -- filters -----------------------------------------------------------------


@pytest.mark.parametrize('b,n,L,padding,comp', [
    (2, 24000, 48000, 'same', 0),      # the v2 reverb: 1 s, 48000-tap IR
    (1, 24000, 48000, 'valid', -1),    # crop window past the convolution
    (2, 40000, 30000, 'valid', 0),     # test_filters_spectral.py:72
])
def test_fft_convolve_single_ir_matches_partitioned(b, n, L, padding, comp):
    """One cuFFT pair in the port vs the JAX 4096-sample partitioned path,
    including the crop window that runs past the convolution
    (filters.py:119-129)."""
    rng = np.random.RandomState(3)
    audio = rng.randn(b, n).astype(np.float32)
    ir = rng.randn(1, L).astype(np.float32)
    assert jfilters.get_fft_size(n, L) >= jfilters._PARTITIONED_MIN_FFT
    want = np.asarray(jfilters.fft_convolve(
        jnp.asarray(audio), jnp.asarray(ir), padding=padding,
        delay_compensation=comp))
    got = tfilters.fft_convolve(_t(audio), _t(ir), padding=padding,
                                delay_compensation=comp)
    assert tuple(got.shape) == want.shape
    # 2e-6 of peak: test_filters_spectral.py:62 (both exact to rounding).
    _close(got, want, 2e-6, 'fft_convolve')


def test_fft_convolve_time_varying_matches():
    rng = np.random.RandomState(1)
    audio = rng.randn(2, 200).astype(np.float32)
    irs = rng.randn(2, 4, 11).astype(np.float32)
    want = jfilters.fft_convolve(jnp.asarray(audio), jnp.asarray(irs),
                                 padding='same', delay_compensation=0)
    _close(tfilters.fft_convolve(_t(audio), _t(irs), padding='same',
                                 delay_compensation=0), want, 1e-6)


@pytest.mark.parametrize('n_frames,n_bands,window', [
    (25, 96, 257),   # the v2 noise synth: 96-sample frames, mm branch
    (10, 33, 0),     # frame 240 > 3/4 of the FFT: rfft branch
])
def test_frequency_filter_matches(n_frames, n_bands, window):
    rng = np.random.RandomState(4)
    audio = rng.uniform(-1, 1, (2, n_frames * (96 if n_bands == 96 else 240))
                        ).astype(np.float32)
    mags = rng.rand(2, n_frames, n_bands).astype(np.float32)
    want = jfilters.frequency_filter(jnp.asarray(audio), jnp.asarray(mags),
                                     window_size=window)
    got = tfilters.frequency_filter(_t(audio), _t(mags), window_size=window)
    # 1e-6 of peak: both are the same f32 matmuls on f64-built constants.
    _close(got, want, 1e-6, 'frequency_filter')


def test_noise_synth_matches_with_injected_noise():
    rng = np.random.RandomState(6)
    mags = rng.randn(3, 20, 96).astype(np.float32)
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.uniform(key, (3, 20 * 96), jnp.float32,
                                          -1.0, 1.0))
    j = jnoise.DynamicSizeFilteredNoise(frame_rate=250, sample_rate=24000)
    want = j.get_signal({}, **j.get_controls({}, jnp.asarray(mags)),
                        rng=key)
    t = tnoise.DynamicSizeFilteredNoise(frame_rate=250, sample_rate=24000)
    got = t.get_signal(**t.get_controls(_t(mags)), noise=_t(noise))
    _close(got, want, 1e-5, 'noise')
    drawn = t.get_signal(**t.get_controls(_t(mags)),
                         generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 20 * 96) and torch.isfinite(drawn).all()


# -- FDN reverb -------------------------------------------------------------


def _fdn_controls(seed, b):
    rng = np.random.RandomState(seed)
    return dict(
        input_gain=0.25 + 0.1 * rng.randn(b, 8),
        output_gain=0.25 + 0.1 * rng.randn(b, 8),
        gain_allpass=0.25 + 0.1 * rng.randn(b, 8, 4),
        delays_allpass=400.0 + 60.0 * rng.randn(b, 8, 4),
        time_rev_0_sec=np.abs(2.0 + 0.5 * rng.randn(b, 1)),
        alpha_tone=1.0 / (1.0 + np.exp(-0.1 * rng.randn(b, 1))),
        early_ir=0.1 * rng.randn(b, 200))


@pytest.mark.parametrize('closed_form', [True, False])
def test_fdn_ir_matches(closed_form):
    sr = 4000.0
    c = {k: v.astype(np.float32) for k, v in _fdn_controls(0, 2).items()}
    got = tfdn.fdn_late_ir(tfdn.FDNParams(**{k: _t(v) for k, v in c.items()}),
                           sr, use_householder_closed_form=closed_form)
    for i in range(2):
        jp = jfdn.FDNParams(**{k: jnp.asarray(v[i]) for k, v in c.items()})
        want = jax.jit(lambda p: jfdn.fdn_late_ir(
            p, sr, use_householder_closed_form=closed_form))(jp)
        # 1e-4 of peak: complex64 exp/divide chains over sr + 1 bins, two
        # libraries' transcendentals.
        _close(got[i], want, 1e-4, f'fdn late ir {i}')


def test_fdn_reverb_module_matches():
    j = jsm.MultiInstrumentFeedbackDelayReverb(n_instruments=3,
                                               sample_rate=4000)
    params = j.init(jax.random.PRNGKey(1))
    ids = np.asarray([[2], [0]], np.int32)
    want = jax.jit(j.apply)(params, jnp.asarray(ids))
    t = tsm.MultiInstrumentFeedbackDelayReverb(n_instruments=3,
                                               sample_rate=4000)
    load_jax_params(t, _np_tree(params))
    _close(t(torch.from_numpy(ids)), want, 1e-4, 'fdn module')


# -- networks ---------------------------------------------------------------


def test_gru_layer_matches():
    j = jnn.GRU(24, 10)
    params = j.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).randn(3, 40, 10).astype(np.float32)
    t = tnn.GRU(24, 10)
    load_jax_params(t, _np_tree(params))
    # atol 1e-6: test_ctrl_kernels.py:100-103.
    np.testing.assert_allclose(t(_t(x)).detach().numpy(),
                               np.asarray(jax.jit(j)(params, jnp.asarray(x))),
                               atol=1e-6)


def test_film_context_network_matches():
    j = jsm.FiLMContextNetwork(n_instruments=4, n_synths=3, layer_dim=16,
                               context_dim=8)
    params = j.init(jax.random.PRNGKey(2))
    rng = np.random.RandomState(2)
    cond = np.zeros((2, 30, 3, 2), np.float32)
    cond[:, 5:, 0, 0] = 60.0
    cond[:, 5:9, 0, 1] = 0.8
    pedal = rng.rand(2, 30, 4).astype(np.float32)
    ids = np.asarray([[1], [7]], np.int32)            # 7: clipped to 3
    want = jax.jit(j.apply)(params, jnp.asarray(cond), jnp.asarray(pedal),
                            jnp.asarray(ids))
    t = tsm.FiLMContextNetwork(n_instruments=4, n_synths=3, layer_dim=16,
                               context_dim=8)
    load_jax_params(t, _np_tree(params))
    got = t(_t(cond), _t(pedal), torch.from_numpy(ids))
    # 1e-5 of peak: LayerNorm/GRU f32, two BLAS summation orders.
    _close(got, want, 1e-5, 'film context')


def test_monophonic_deep_network_matches():
    splits = (('amplitudes', 1), ('harmonic_distribution', 12),
              ('magnitudes', 8))
    kw = dict(rnn_channels=20, ch=8, layers_per_stack=2, context_dim=6,
              output_splits=splits)
    j = jsm.MonophonicDeepNetwork(**kw)
    params = j.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(3)
    cond = rng.rand(4, 25, 2).astype(np.float32) * [90.0, 1.0]
    pitch = cond[..., :1].astype(np.float32)
    context = rng.randn(4, 25, 6).astype(np.float32)
    want = jax.jit(j.apply)(params, jnp.asarray(cond, jnp.float32),
                            jnp.asarray(pitch), jnp.asarray(context))
    t = tsm.MonophonicDeepNetwork(**kw)
    load_jax_params(t, _np_tree(params))
    got = t(_t(cond), _t(pitch), _t(context))
    for (name, _), g, w in zip(splits, got, want):
        _close(g, w, 1e-5, name)


def test_joint_tuning_matches_v2_weights():
    from ddsp_piano_torch.configs.maestro_v2 import V2_TUNING_WEIGHTS
    j = jsm.JointParametricInharmTuning(pretrained_weights=V2_TUNING_WEIGHTS)
    params = j.init(jax.random.PRNGKey(0))
    pitch = np.tile(np.arange(21, 109, dtype=np.float32)[None, :, None],
                    (10, 1, 1))
    ids = np.arange(10, dtype=np.int32)[:, None]
    f0_w, b_w = j.apply(params, jnp.asarray(pitch), jnp.asarray(ids))
    t = tsm.JointParametricInharmTuning(pretrained_weights=V2_TUNING_WEIGHTS)
    tnn.init_weights(t, seed=0)                 # the port's own table
    f0_g, b_g = t(_t(pitch), torch.from_numpy(ids))
    # 1e-6 relative: exp/tanh/pow of two libraries.
    np.testing.assert_allclose(f0_g.detach().numpy(), np.asarray(f0_w),
                               rtol=1e-6)
    np.testing.assert_allclose(b_g.detach().numpy(), np.asarray(b_w),
                               rtol=1e-5)


def test_note_release_module_matches():
    j = jsm.NoteRelease(frame_rate=250)
    params = j.init(jax.random.PRNGKey(0))
    cond = np.zeros((3, 400, 2), np.float32)
    cond[0, 10:50, 0] = 60.0
    cond[1, 100:110, 0] = 40.0
    cond[1, 300:320, 0] = 41.0
    want = j.apply(params, jnp.asarray(cond))
    t = tsm.NoteRelease(frame_rate=250)
    load_jax_params(t, _np_tree(params))
    np.testing.assert_array_equal(t(_t(cond)).detach().numpy(),
                                  np.asarray(want))


def test_multi_inharmonic_matches():
    rng = np.random.RandomState(8)
    b, nf, K = 3, 30, 24
    amps = rng.randn(b, nf, 1).astype(np.float32)
    dist = rng.randn(b, nf, K).astype(np.float32)
    inharm = (rng.rand(b, nf, 1) * 1e-3).astype(np.float32)
    f0 = rng.uniform(30, 2000, (b, nf, 1)).astype(np.float32)
    f0[0, :10] = 0.0
    j = jinharm.MultiInharmonic(frame_rate=250, sample_rate=24000)
    jc = j.get_controls({}, *map(jnp.asarray, (amps, dist, inharm, f0)))
    want = j.get_signal({}, **jc)
    t = tinharm.MultiInharmonic(frame_rate=250, sample_rate=24000)
    tc = t.get_controls(*map(_t, (amps, dist, inharm, f0)))
    for k in tc:
        _close(tc[k], jc[k], 1e-6, k)
    # 1e-4 of peak: test_oscillator.py:190.
    _close(t.get_signal(**tc), want, 1e-4, 'signal')


# -- weights bridge ----------------------------------------------------------


def test_load_jax_params_rejects_mismatches():
    tree = {'kernel': np.zeros((3, 4), np.float32),
            'bias': np.zeros((4,), np.float32)}
    load_jax_params(tnn.Dense(4, 3), tree)
    with pytest.raises(ValueError, match='missing'):
        load_jax_params(tnn.Dense(4, 3), {'kernel': tree['kernel']})
    with pytest.raises(ValueError, match='extra'):
        load_jax_params(tnn.Dense(4, 3), dict(tree, gamma=np.zeros(4)))
    with pytest.raises(ValueError, match='shape'):
        load_jax_params(tnn.Dense(4, 3), dict(tree, bias=np.zeros(5)))


def test_port_init_is_seeded_and_keras_shaped():
    a = tnn.init_weights(tnn.GRU(8, 5), seed=3)
    b = tnn.init_weights(tnn.GRU(8, 5), seed=3)
    assert torch.equal(a.kernel, b.kernel)
    u = a.recurrent_kernel.detach()
    # Orthogonal recurrent kernel (u, 3u): orthonormal rows.
    np.testing.assert_allclose((u @ u.T).numpy(), np.eye(8), atol=1e-5)
    assert torch.count_nonzero(a.bias) == 0
