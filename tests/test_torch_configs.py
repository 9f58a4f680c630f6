"""The five configurations ported last (enstdkcl_8khz, enstdkcl_32khz,
multi_instruments, surrogate, maestro_v2_regularized): their modules and
their whole renders, JAX package vs port, on the CPU.

Module tests feed numpy inputs from a seed through the JAX module and the
port's, with the JAX module's params loaded by params.load_jax_params.
Each configuration then renders 0.5 s at its published widths from the
JAX package's PRNGKey(0) init weights, with the JAX noise draw injected;
the JAX side runs the tuning and the additive synth op by op, as
tests/test_torch_render.py explains, and the rest jitted. The same forward computes the
training losses against a fixed target.
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
from ddsp_piano_torch.configs import (available_configs,  # noqa: E402
                                      config_rates, get_model)
from ddsp_piano_torch.models import losses as tlosses  # noqa: E402
from ddsp_piano_torch.models import sub_modules as tsm  # noqa: E402
from ddsp_piano_torch.ops import core as tcore  # noqa: E402
from ddsp_piano_torch.ops import oscillator as tosc  # noqa: E402
from ddsp_piano_torch.params import flatten_tree, load_jax_params  # noqa
from ddsp_piano_torch.processors import reverb as treverb  # noqa: E402
from ddsp_piano_torch.processors import surrogate as tsur  # noqa: E402
from ddsp_piano_tpu import nn as jnn  # noqa: E402
from ddsp_piano_tpu.models import losses as jlosses  # noqa: E402
from ddsp_piano_tpu.models import sub_modules as jsm  # noqa: E402
from ddsp_piano_tpu.ops import core as jcore  # noqa: E402
from ddsp_piano_tpu.ops import oscillator as josc  # noqa: E402
from ddsp_piano_tpu.processors import reverb as jreverb  # noqa: E402
from ddsp_piano_tpu.processors import surrogate as jsur  # noqa: E402
from test_torch_configs_training import SMALL as GRAD_SMALL  # noqa: E402
from test_torch_configs_training import _batch as _grad_batch  # noqa: E402

NEW_CONFIGS = ('enstdkcl_8khz', 'enstdkcl_32khz', 'multi_instruments',
               'surrogate', 'maestro_v2_regularized')


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _peak_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _ulps(got, want):
    """Largest distance in float32 units in the last place."""
    got = np.ascontiguousarray(got.detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.ascontiguousarray(want, np.float32)
    return int(np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64)).max())


def test_available_configs_match_jax():
    from ddsp_piano_tpu.configs import available_configs as jax_available

    assert available_configs() == jax_available()


# -- ops/core.py -------------------------------------------------------------


def test_core_helpers_match_jax():
    x = (np.random.RandomState(0).randn(4, 30, 8) * 3).astype(np.float32)
    # rtol 1e-6 and atol 1.2e-7 (2 ulp of 1): tanh of two libraries differs
    # by an ulp near -1, where tanh + 1 cancels; then pow (dafx22's
    # exp_sigmoid tolerance).
    for name in ('positive_tanh', 'exp_tanh'):
        np.testing.assert_allclose(
            getattr(tcore, name)(_t(x)).numpy(),
            np.asarray(getattr(jcore, name)(jnp.asarray(x))), rtol=1e-6,
            atol=1.2e-7, err_msg=name)
    np.testing.assert_allclose(
        tcore.exp_tanh(_t(x), max_value=1.0, exponent=3.0, gain=0.5).numpy(),
        np.asarray(jcore.exp_tanh(jnp.asarray(x), max_value=1.0,
                                  exponent=3.0, gain=0.5)), rtol=1e-6,
        atol=1.2e-7)
    f0 = np.array([[[27.5], [440.0], [4186.0]]], np.float32)
    for n in (48, 96, 192):
        # Exact: the same float32 harmonic numbers times f0.
        np.testing.assert_array_equal(
            tcore.get_harmonic_frequencies(_t(f0), n).numpy(),
            np.asarray(jcore.get_harmonic_frequencies(jnp.asarray(f0), n)))


# -- models/sub_modules.py ---------------------------------------------------


def _pitches(n=4, seed=0):
    pitch = np.tile(np.arange(21, 109, dtype=np.float32)[None, :, None],
                    (n, 1, 1))
    pitch[1, ::3] += 0.37                     # fractional (released) pitch
    return pitch


@pytest.mark.parametrize('with_z', [False, True], ids=['pedal', 'film'])
def test_simple_context_net_matches_jax(with_z):
    def layers(nn_mod):
        return [nn_mod.Dense(8, 4, activation='leaky_relu'),
                nn_mod.GRU(12, 8), nn_mod.Normalize(12)]

    j = jsm.SimpleContextNet(layers(jnn), out_features=12,
                             output_splits=(('context', 6),))
    params = j.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    pedal = rng.rand(2, 30, 4).astype(np.float32)
    z = rng.randn(2, 30, 12).astype(np.float32) if with_z else None
    want = jax.jit(j.apply)(params, jnp.asarray(pedal),
                            None if z is None else jnp.asarray(z))
    t = tsm.SimpleContextNet(layers(tnn), out_features=12,
                             output_splits=(('context', 6),))
    load_jax_params(t, _np_tree(params))
    got = t.apply_features({'pedal': _t(pedal), 'z': None if z is None
                            else _t(z)})['context']
    # 1e-5 of peak: GRU and Normalize in float32, two BLAS orders (the
    # context network tests of test_torch_dafx22.py).
    assert _peak_err(got, want) <= 1e-5


def test_context_network_normalizes_pitch_as_jax():
    n_synths, z_dim = 3, 5

    def layers(nn_mod):
        return [nn_mod.Dense(8, 2 * n_synths + 4 + z_dim,
                             activation='leaky_relu'),
                nn_mod.GRU(12, 8), nn_mod.Normalize(12)]

    j = jsm.ContextNetwork(layers(jnn), out_features=12,
                           output_splits=(('context', 6),),
                           normalize_pitch=True)
    params = j.init(jax.random.PRNGKey(2))
    rng = np.random.RandomState(2)
    cond = (rng.rand(2, 30, n_synths, 2) * [90.0, 1.0]).astype(np.float32)
    pedal = rng.rand(2, 30, 4).astype(np.float32)
    z = rng.randn(2, 30, z_dim).astype(np.float32)
    want, = jax.jit(j.apply)(params, jnp.asarray(cond), jnp.asarray(pedal),
                             jnp.asarray(z))
    t = tsm.ContextNetwork(layers(tnn), out_features=12,
                           output_splits=(('context', 6),),
                           normalize_pitch=True)
    load_jax_params(t, _np_tree(params))
    got, = t(_t(cond), _t(pedal), _t(z))
    assert _peak_err(got, want) <= 1e-5


def test_parametric_tuning_matches_jax():
    """f0_hz within 1 ulp of JAX eager (its float32 exp, tanh and sqrt
    against the port's, rounded once from float64), inharm_coef within
    rtol 1e-6; with and without the global inharmonicity, trainable
    leaves nonzero."""
    j = jsm.ParametricTuning()
    rng = np.random.RandomState(3)
    params = dict(j.init(jax.random.PRNGKey(0)),
                  model_specific_weight=jnp.asarray([0.3], jnp.float32),
                  slopes_modifier=jnp.asarray(0.05 * rng.randn(2),
                                              jnp.float32),
                  offsets_modifier=jnp.asarray(0.02 * rng.randn(2),
                                               jnp.float32))
    pitch = _pitches()
    gi = (0.05 * rng.randn(4, 88, 1)).astype(np.float32)
    t = tsm.ParametricTuning()
    load_jax_params(t, _np_tree(params))
    ulps = []
    for global_inharm in (None, gi):
        want = j.apply(params, jnp.asarray(pitch),
                       None if global_inharm is None
                       else jnp.asarray(global_inharm))
        got = t.apply_features({'extended_pitch': _t(pitch),
                                'global_inharm': None if global_inharm
                                is None else _t(global_inharm)})
        ulps.append(_ulps(got['f0_hz'], want[0]))
        np.testing.assert_allclose(got['inharm_coef'].detach().numpy(),
                                   np.asarray(want[1]), rtol=1e-6)
    print(f"\nParametricTuning f0_hz: {ulps} ulp from JAX eager")
    assert max(ulps) <= 1, ulps
    np.testing.assert_allclose(float(t.regularization().detach()),
                               float(j.regularization(params)), rtol=1e-6)


def test_dict_inharmonicity_model_matches_jax():
    j = jsm.DictInharmonicityModel(n_instruments=10)
    table = (1e-4 * np.random.RandomState(4).randn(1280, 1)).astype(
        np.float32)
    params = {'layer': {'embeddings': jnp.asarray(table)}}
    pitch = _pitches()
    t = tnn.init_weights(tsm.DictInharmonicityModel(n_instruments=10), 0)
    assert torch.count_nonzero(t.layer.embeddings) == 0   # zeros init
    load_jax_params(t, _np_tree(params))
    # Exact: a lookup of the pitch's integer part; the penalty sums the
    # negative entries (rtol 1e-6: 1280 values in two orders).
    np.testing.assert_array_equal(
        t(_t(pitch)).detach().numpy(),
        np.asarray(j.apply(params, jnp.asarray(pitch))))
    np.testing.assert_allclose(float(t.regularization().detach()),
                               float(j.regularization(params)), rtol=1e-6)


@pytest.mark.parametrize('use_detune', [True, False])
def test_deep_detuner_matches_jax(use_detune):
    j = jsm.DeepDetuner(n_substrings=2, use_detune=use_detune)
    params = j.init(jax.random.PRNGKey(5))
    rng = np.random.RandomState(5)
    params['out_layer'] = {
        'kernel': jnp.asarray(0.3 * rng.randn(32, 2), jnp.float32),
        'bias': jnp.asarray(0.1 * rng.randn(2), jnp.float32)}
    pitch = _pitches()
    gd = (0.05 * rng.randn(4, 88, 1)).astype(np.float32)
    want = j.apply(params, jnp.asarray(pitch), jnp.asarray(gd))
    t = tsm.DeepDetuner(n_substrings=2, use_detune=use_detune)
    load_jax_params(t, _np_tree(params))
    got = t(_t(pitch), _t(gd))
    assert tuple(got.shape) == ((4, 88, 2) if use_detune else (4, 88, 1))
    # rtol 1e-6: an FcStack, tanh and pow of two libraries (the Detuner's).
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    fresh = tnn.init_weights(tsm.DeepDetuner(), seed=0)
    assert torch.count_nonzero(fresh.out_layer.kernel) == 0


def test_surrogate_module_matches_jax():
    """Decays exactly (an embedding lookup) and decay_time exactly (frames
    since the last onset, the carried count before the first), with and
    without a carried state."""
    j = jsm.SurrogateModule(n_harmonics=12)
    table = (0.5 + 0.5 * np.random.RandomState(6).rand(128, 12)).astype(
        np.float32)
    params = {'amp_model': {'embeddings': jnp.asarray(table)}}
    cond = np.zeros((3, 40, 2), np.float32)
    cond[0, 5:, 0] = 60.0
    cond[0, [5, 17, 18, 30], 1] = 0.8
    cond[1, :, 0] = 47.0
    cond[1, 0, 1] = 0.5
    cond[2, 12:, 0] = 72.5                    # one onset late, none early
    cond[2, 12, 1] = 0.3
    pitch = cond[..., :1].copy()
    t = tnn.init_weights(tsm.SurrogateModule(n_harmonics=12), 0)
    assert bool(torch.all(t.amp_model.embeddings == 1.0))  # ones init
    load_jax_params(t, _np_tree(params))
    carry = np.array([[[0.0]], [[7.0]], [[120.0]]], np.float32)
    for state in (None, carry):
        want = j.apply(params, jnp.asarray(cond), jnp.asarray(pitch),
                       initial_state=None if state is None
                       else jnp.asarray(state), return_state=True)
        got = t(_t(cond), _t(pitch),
                initial_state=None if state is None else _t(state),
                return_state=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


def _decay_controls(b=3, t=40, k=12, sr=16000, seed=7):
    rng = np.random.RandomState(seed)
    f0 = np.repeat((110.0 * 2 ** rng.rand(b, 1, 1)), t, 1).astype(
        np.float32)
    f0[0, 20:] *= 1.5                         # a jump
    amps = rng.rand(b, t, 1).astype(np.float32)
    dist = rng.rand(b, t, k).astype(np.float32)
    shifts = (1e-4 * rng.rand(b, t, k)).astype(np.float32)
    decays = (0.9 + 0.1 * rng.rand(b, t, k)).astype(np.float32)
    decay_time = np.tile(np.arange(t, dtype=np.float32)[None, :, None],
                         (b, 1, 1))
    return f0, amps, dist, shifts, decays, decay_time


def test_surrogate_synthesis_matches_jax():
    """surrogate_harmonic_synthesis (framewise controls, then the decay
    render) at up = 64 against the JAX package's jnp render: 1e-4 of peak,
    the floor of its float32 phase cumsum over 40 frames (the port sums in
    float64); the decay render alone on the same controls, 1e-5."""
    f0, amps, dist, shifts, decays, decay_time = _decay_controls()
    args = dict(upsampling=64, sample_rate=16000)
    want = jsur.surrogate_harmonic_synthesis(
        jnp.asarray(f0), jnp.asarray(amps), jnp.asarray(decays),
        jnp.asarray(decay_time), jnp.asarray(shifts), jnp.asarray(dist),
        **args)
    got = tsur.surrogate_harmonic_synthesis(
        _t(f0), _t(amps), _t(decays), _t(decay_time), _t(shifts), _t(dist),
        **args)
    assert _peak_err(got, want) <= 1e-4
    freqs = tcore.get_harmonic_frequencies(_t(f0), 12) * (1.0 + _t(shifts))
    controls = tosc.framewise_osc_controls(freqs, _t(amps) * _t(dist), 64,
                                           16000)
    jcontrols = josc.FramewiseOscControls(
        *(jnp.asarray(c.numpy()) for c in controls))
    want = jsur.render_framewise_decay(jcontrols, jnp.asarray(decays),
                                       jnp.asarray(decay_time), 64, 16000)
    got = tsur.render_framewise_decay(controls, _t(decays), _t(decay_time),
                                      64, 16000)
    # 1e-5 of peak: exp, log and cos of two libraries over 12 partials.
    assert _peak_err(got, want) <= 1e-5


def test_surrogate_additive_controls_match_jax():
    """Scaling, stiff-string partials, decays clipped and set to 1 above
    Nyquist, amplitudes gated below min_frequency."""
    f0, amps, dist, _, decays, decay_time = _decay_controls(k=96)
    f0[1] = 10.0                              # below min_frequency
    f0[2] = 300.0                             # partials past Nyquist
    decays[0, :4] = 2.0                       # clipped to 1
    decays[0, 4:8] = 0.0                      # clipped to 1e-5
    inharm = np.full_like(amps, 1e-4)
    inharm[0, 0] = -1e-3                      # clamped to 0
    j = jsur.SurrogateAdditive(scale_fn=jcore.exp_tanh,
                               normalize_harm_distribution=False)
    t = tsur.SurrogateAdditive(scale_fn=tcore.exp_tanh,
                               normalize_harm_distribution=False)
    want = j.get_controls({}, jnp.asarray(amps), jnp.asarray(decays),
                          jnp.asarray(decay_time), jnp.asarray(dist),
                          jnp.asarray(inharm), jnp.asarray(f0))
    got = t.get_controls(_t(amps), _t(decays), _t(decay_time), _t(dist),
                         _t(inharm), _t(f0))
    assert sorted(got) == sorted(want)
    for key in ('decays', 'decay_time', 'f0_hz'):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), key)
    for key in ('amplitudes', 'harmonic_distribution', 'harmonic_shifts'):
        # rtol 1e-6: exp_tanh and sqrt of two libraries.
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-12, err_msg=key)


@pytest.mark.parametrize('sample_rate,delay_lines', [(8000, 8), (32000, 6)])
def test_trainable_fdn_matches_jax(sample_rate, delay_lines):
    """The ENSTDkCl models' standalone FDN: its parameters map to controls
    as the JAX processor maps them, the trainable delay lines included;
    the IR (1e-5 of peak: the complex64 frequency response and irfft of
    two libraries) and the reverberated signal (no dry mask, no dry add;
    1e-5 of peak)."""
    j = jreverb.FeedbackDelayNetwork(trainable=True, delay_trainable=True,
                                     delay_lines=delay_lines,
                                     sampling_rate=sample_rate)
    params = j.init(jax.random.PRNGKey(sample_rate))
    audio = np.random.RandomState(8).randn(2, sample_rate // 2).astype(
        np.float32)
    want = j.get_controls(params, jnp.asarray(audio))
    t = treverb.FeedbackDelayNetwork(trainable=True, delay_trainable=True,
                                     delay_lines=delay_lines,
                                     sampling_rate=sample_rate)
    load_jax_params(t, _np_tree(params))
    assert sorted(n for n, _ in t.named_parameters()) == sorted(params)
    got = t.get_controls(_t(audio))
    assert tuple(got['ir'].shape) == (1, 2 * sample_rate)
    assert _peak_err(got['ir'][0], want['ir']) <= 1e-5
    signal = t.get_signal(**got)
    assert _peak_err(signal, j.get_signal(params, **want)) <= 1e-5
    # The port's own init draws every trainable leaf; a fixed-delay FDN
    # keeps the prime lengths as a buffer, not a parameter.
    fresh = tnn.init_weights(treverb.FeedbackDelayNetwork(
        trainable=True, delay_trainable=True, delay_lines=delay_lines,
        sampling_rate=sample_rate), seed=0)
    assert 300.0 < float(fresh.delay_values.detach().mean()) < 500.0
    fixed = treverb.FeedbackDelayNetwork(trainable=True,
                                         sampling_rate=sample_rate)
    assert 'delay_values' not in dict(fixed.named_parameters())


def test_wet_only_reverb_and_one_second_ir_match_jax():
    """multi_instruments' Reverb(add_dry=False); surrogate's 1 s learned IR
    at 16 kHz, whose inference decay mask has no decaying part (the
    linspace over reverb_length - 16000 = 0 samples is empty)."""
    rng = np.random.RandomState(9)
    audio = rng.randn(2, 8000).astype(np.float32)
    ir = (0.1 * rng.randn(2, 4000)).astype(np.float32)
    want = jreverb.Reverb(add_dry=False).get_signal(
        {}, jnp.asarray(audio), jnp.asarray(ir))
    got = treverb.Reverb(add_dry=False).get_signal(_t(audio), _t(ir))
    assert _peak_err(got, want) <= 1e-5
    j = jsm.MultiInstrumentReverb(n_instruments=1, reverb_duration=1.0,
                                  sample_rate=16000, inference=True)
    params = j.init(jax.random.PRNGKey(10))
    t = tsm.MultiInstrumentReverb(n_instruments=1, reverb_duration=1.0,
                                  sample_rate=16000, inference=True)
    load_jax_params(t, _np_tree(params))
    ids = np.asarray([[0], [4]], np.int32)
    got = t(torch.from_numpy(ids))
    assert tuple(got.shape) == (2, 16000)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(j.apply(params,
                                                     jnp.asarray(ids))))


def test_inharmonicity_loss_matches_jax():
    inharm = (1e-3 * np.random.RandomState(11).randn(4, 2, 30, 1)).astype(
        np.float32)
    want = jlosses.InharmonicityLoss().compute(
        {'inharm_coef': jnp.asarray(inharm)})
    got = tlosses.InharmonicityLoss().compute({'inharm_coef': _t(inharm)})
    assert float(want) > 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the models: phases, rates and params --------------------------------------


@pytest.fixture(scope='module')
def jax_inits():
    """Each new config's JAX model (0.5 s, inference) and its PRNGKey(0)
    init, once per module."""
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    out = {}
    for config in NEW_CONFIGS:
        jmodel = jax_get_model(config, duration=0.5, inference=True)
        out[config] = (jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    return out


@pytest.mark.parametrize('config', NEW_CONFIGS)
@pytest.mark.parametrize('first_phase', [True, False, None],
                         ids=['phase1', 'phase2', 'all'])
def test_trainable_mask_matches_jax(jax_inits, config, first_phase):
    jmodel, params = jax_inits[config]
    want = dict(flatten_tree(jax.tree.map(
        bool, jmodel.trainable_mask(params, first_phase=first_phase))))
    model = get_model(config, duration=0.5, inference=True, device='cpu')
    got = model.trainable_mask(first_phase)
    assert got == want
    assert set(got) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize('config', NEW_CONFIGS)
def test_config_rates_and_params_match_jax(jax_inits, config):
    """The rates the synthesize CLI reads before building, and the JAX
    init tree loaded leaf for leaf (load_jax_params raises on a missing,
    extra or mis-shaped leaf)."""
    jmodel, params = jax_inits[config]
    rates = config_rates(config)
    assert rates == {'sample_rate': jmodel.sample_rate,
                     'frame_rate': jmodel.frame_rate,
                     'n_synths': jmodel.n_synths}
    model = get_model(config, duration=0.5, inference=True, device='cpu')
    load_jax_params(model, _np_tree(params))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree.leaves(params))


# -- the whole renders -----------------------------------------------------


def _conditioning(n_frames=125):
    """tests/test_torch_render.py's five notes, over 0.5 s."""
    cond = np.zeros((1, n_frames, 16, 2), np.float32)
    for voice, (pitch, start) in enumerate([(43, 5), (55, 5), (59, 35),
                                            (62, 65), (67, 95)]):
        cond[:, start:, voice, 0] = pitch
        cond[:, start:start + 8, voice, 1] = 0.7
    return cond


_RENDERS = {}


def _render(config, jax_inits):
    """(JAX outputs, port outputs, port model) of a 0.5 s render with
    the training losses against a fixed target, once per config."""
    if config in _RENDERS:
        return _RENDERS[config]
    jmodel, params = jax_inits[config]
    if config == 'multi_instruments':
        # Negative entries in the inharmonicity table, so that the penalty
        # and the synth's clamp both act.
        table = 1e-4 * np.random.RandomState(12).randn(1280, 1)
        params = dict(params, inharm_model={'layer': {
            'embeddings': jnp.asarray(table, jnp.float32)}})
    # The networks, the learned IR, the noise synth, the convolution and
    # the spectral loss run jitted (their outputs carry no phase); the
    # tuning and the additive synth op by op.
    for net in (jmodel.context_network, jmodel.monophonic_network,
                jmodel.reverb_model):
        if net is not None:
            net.apply = jax.jit(net.apply, static_argnames='training')
    group = jmodel.processor_group
    for proc in (group.noise, group.reverb):
        proc.get_signal = jax.jit(proc.get_signal)
    jmodel.loss_objs[0]._loss = jax.jit(jmodel.loss_objs[0]._loss)
    sr = jmodel.sample_rate
    cond = _conditioning()
    pedal = np.zeros((1, 125, 4), np.float32)
    pedal[:, 60:, 0] = 0.8
    target = np.random.RandomState(13).uniform(-0.5, 0.5, (1, sr // 2))
    target = target.astype(np.float32)
    rng = jax.random.PRNGKey(7)
    jout = jmodel(params, {'conditioning': jnp.asarray(cond),
                           'pedal': jnp.asarray(pedal),
                           'piano_model': jnp.asarray([[3]], np.int32),
                           'audio': jnp.asarray(target)},
                  training=True, rng=rng)
    # The noise synth's draw inside VectorizedPolyphonicProcessorGroup.
    noise = jax.random.uniform(jax.random.fold_in(rng, 1), (16, sr // 2),
                               jnp.float32, -1.0, 1.0)
    model = get_model(config, inference=True, duration=0.5, device='cpu')
    load_jax_params(model, _np_tree(params))
    with torch.inference_mode():
        tout = model({'conditioning': torch.from_numpy(cond),
                      'pedal': torch.from_numpy(pedal),
                      'piano_model': torch.tensor([[3]]),
                      'audio': torch.from_numpy(target)},
                     noise=torch.from_numpy(np.array(noise)),
                     training=True)
    _RENDERS[config] = (jout, tout, model)
    return _RENDERS[config]


@pytest.mark.parametrize('config', NEW_CONFIGS)
def test_render_matches_jax(jax_inits, config):
    """Wet and dry audio within 1.1e-4 of peak (C.2's float32-cumsum floor
    of the JAX side); the controls: f0_hz, inharm_coef and decays within
    rtol 1e-5, decay_time exact, the reverb IR within 1e-5 of its peak
    (the learned IRs are exact; the FDN's complex64 response and irfft
    differ by rounding)."""
    jout, tout, model = _render(config, jax_inits)
    errs = {}
    for stem, got, want in (('wet', tout['audio_synth'], jout['audio_synth']),
                            ('dry', tout['add']['signal'],
                             jout['add']['signal'])):
        assert np.isfinite(got.numpy()).all()
        assert np.abs(np.asarray(want)).max() > 0.0
        errs[stem] = _peak_err(got, want)
    print(f"\n{config}: wet {errs['wet']:.3g}, dry {errs['dry']:.3g} of peak")
    assert max(errs.values()) <= 1.1e-4, errs
    for key in ('f0_hz', 'inharm_coef', 'decays'):
        if key in jout:
            np.testing.assert_allclose(tout[key].numpy(),
                                       np.asarray(jout[key]), rtol=1e-5,
                                       err_msg=key)
    assert ('decays' in jout) == (config == 'surrogate')
    if 'decay_time' in jout:
        np.testing.assert_array_equal(tout['decay_time'].numpy(),
                                      np.asarray(jout['decay_time']))
    if 'DelayNetwork' in jout:
        with torch.inference_mode():
            ir = model.processor_group.reverb.trained_ir()
        assert _peak_err(ir[0], jout['DelayNetwork']['controls']['ir']) \
            <= 1e-5
    else:
        assert _peak_err(tout['reverb_ir'], jout['reverb_ir']) <= 1e-5


@pytest.mark.parametrize('config', NEW_CONFIGS)
def test_losses_match_jax(jax_inits, config):
    """Every loss of the config's list, the regularization loss and the
    total within rtol 1e-4 (the render tolerance as a share of the loss,
    test_torch_training.py's whole-step loss)."""
    jout, tout, _ = _render(config, jax_inits)
    want, got = jout['losses'], tout['losses']
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-4,
                                   atol=1e-12, err_msg=key)
    if config in ('multi_instruments', 'maestro_v2_regularized'):
        assert float(want['regularization_loss']) > 0.0

# -- ROADMAP C.5: enstdkcl_8khz's trainable FDN gradients in float64 --------
#
# At a 0.5 s segment, against jax.grad. In float32,
# test_torch_configs_training.py measured the t60 leaf 0.64 of its peak
# apart from jax.grad at 0.5 s (1e-4 at 2 s, the FDN IR's length, where that
# test runs). Here both sides run in float64 as far as each
# package goes: the port's model ``.double()``, the JAX model under
# ``jax.enable_x64`` (in this test only) with float64 parameters and inputs.
# Both packages keep float32 where their code casts to it: the FDN's transfer
# function (complex64) and IR, the loss's magnitudes and the harmonic
# numbers. The gap falls from 0.64 to 3.35e-3 of the t60 leaf's peak
# (1.6e-4 for the tone leaf): rounding, not a fault. It cannot reach 1e-6:
# JAX's own jitted and op-by-op gradients of this step, in the same float64
# mode, differ by 0.396 of the t60 leaf's peak (0.0133 for the tone), so the
# 0.5 s t60 gradient is ill-conditioned. Held: every FDN leaf within 1e-2 of
# its peak, and the t60 and tone leaves nearer the op-by-op JAX gradient
# than JAX's jitted one is.

FDN_CONFIG = 'enstdkcl_8khz'
FDN_SECONDS = 0.5
FDN = 'processor_group.DelayNetwork.'
T60, TONE = FDN + 'time_rev_0_sec', FDN + 'alpha_tone'
# Each FDN leaf's gap, a share of its peak (measured 3.35e-3 at most, the
# t60 leaf).
FDN_TOL = 1e-2


def _jax_gradients():
    """jax.grad of the whole step in float64: op by op for the tuning and
    the additive synth, jitted elsewhere (as test_torch_configs_training's
    _jax_step), and all jitted; the params, batch and noise draw."""
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    jmodel = jax_get_model(FDN_CONFIG, duration=FDN_SECONDS,
                           first_phase=False, **GRAD_SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jmodel.loss_objs[0].logmag_weight = 0.0
    batch = _grad_batch(jmodel.sample_rate,
                        int(FDN_SECONDS * jmodel.frame_rate))
    rng = jax.random.PRNGKey(7)
    # The noise synth's draw (float32 in the JAX package, x64 or not).
    noise = np.array(jax.random.uniform(
        jax.random.fold_in(rng, 1), (8, batch['audio'].shape[1]),
        jnp.float32, -1.0, 1.0))
    grads = {}
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           params)
        feats = {k: jnp.asarray(v, jnp.float64 if v.dtype.kind == 'f'
                                else v.dtype) for k, v in batch.items()}

        def total(p):
            return jmodel(p, feats, training=True,
                          rng=rng)['losses']['total_loss']

        flat = lambda g: dict(flatten_tree(jax.tree.map(
            lambda a: np.asarray(a, np.float64), g)))
        grads['jit'] = flat(jax.jit(jax.grad(total))(p64))
        for net in (jmodel.context_network, jmodel.monophonic_network,
                    jmodel.reverb_model):
            if net is not None:
                net.apply = jax.jit(net.apply, static_argnames='training')
        for proc in (jmodel.processor_group.noise,
                     jmodel.processor_group.reverb):
            proc.get_signal = jax.jit(proc.get_signal)
        for loss in jmodel.loss_objs:
            if hasattr(loss, '_loss'):
                loss._loss = jax.jit(loss._loss)
        grads['op_by_op'] = flat(jax.grad(total)(p64))
    return grads, params, batch, noise


def test_fdn_gradients_in_float64_match_jax():
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.training.trainer import Trainer

    want, params, batch, noise = _jax_gradients()
    model = get_model(FDN_CONFIG, device='cpu', duration=FDN_SECONDS,
                      first_phase=False, **GRAD_SMALL)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    model.double()
    model.loss_objs[0].logmag_weight = 0.0
    trainer = Trainer(model, first_phase=None)
    trainer.forward_backward(
        {k: torch.from_numpy(v).double() if v.dtype.kind == 'f'
         else torch.from_numpy(v) for k, v in batch.items()},
        noise=torch.from_numpy(noise).double())
    got = {n: p.grad.numpy() for n, p in trainer.named_params
           if n.startswith(FDN)}
    assert T60 in got and TONE in got and len(got) == 8
    assert all(g.dtype == np.float64 for g in got.values())

    def gap(a, b):
        return np.abs(a - b).max() / np.abs(b).max()

    errs = {n: gap(g, want['op_by_op'][n]) for n, g in got.items()}
    spread = {n: gap(want['jit'][n], want['op_by_op'][n])
              for n in (T60, TONE)}
    print(f"\nfloat64, {FDN_CONFIG} at {FDN_SECONDS} s, FDN leaves against "
          f"JAX op by op: {errs}; JAX jitted against op by op: {spread}")
    assert max(errs.values()) <= FDN_TOL, errs
    for n in (T60, TONE):
        assert errs[n] < spread[n], (n, errs[n], spread[n])
