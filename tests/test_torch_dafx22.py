"""The dafx22 slice: its modules and its whole render, JAX package vs port.

Module tests use small widths where the module takes them; JAX params come
from the JAX module's own init and reach the port through
params.load_jax_params. The whole render runs dafx22 at full width, 1 s,
batch 1, PRNGKey(42) init weights and the JAX noise draw injected, once
with each of the port's oscillators. Its JAX side runs op by op (no jit)
outside the two networks, as tests/test_torch_render.py explains.
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
from ddsp_piano_torch.configs import config_rates, get_model  # noqa: E402
from ddsp_piano_torch.models import losses as tlosses  # noqa: E402
from ddsp_piano_torch.models import sub_modules as tsm  # noqa: E402
from ddsp_piano_torch.ops import core as tcore  # noqa: E402
from ddsp_piano_torch.params import flatten_tree, load_jax_params  # noqa
from ddsp_piano_tpu import nn as jnn  # noqa: E402
from ddsp_piano_tpu.models import losses as jlosses  # noqa: E402
from ddsp_piano_tpu.models import sub_modules as jsm  # noqa: E402
from ddsp_piano_tpu.ops import core as jcore  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _close(got, want, rel, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: max error {err:.3g} of peak > {rel:g}"


# -- ops/core.py: resampling -----------------------------------------------


@pytest.mark.parametrize('method,shape,n_out,add_endpoint,rtol,atol', [
    # test_core_ops.py:89 (rtol 1e-4, atol 1e-5): up, down, align_corners.
    ('linear', (2, 7, 3), 25, True, 1e-4, 1e-5),
    ('linear', (2, 40, 3), 13, True, 1e-4, 1e-5),
    ('linear', (3, 9), 31, False, 1e-4, 1e-5),
    ('linear', (2, 1, 16), 250, True, 0.0, 0.0),    # OneHotZEncoder: exact
    # test_core_ops.py:99 (rtol 1e-5).
    ('nearest', (2, 10, 4), 25, True, 1e-5, 0.0),
    ('nearest', (12,), 5, True, 1e-5, 0.0),
    # test_core_ops.py:116 (rtol 1e-4, atol 1e-5); rank 4 as well.
    ('window', (2, 5, 3), 40, True, 1e-4, 1e-5),
    ('window', (2, 5, 2, 3), 40, False, 1e-4, 1e-5),
], ids=['linear-up', 'linear-down', 'linear-corners', 'linear-1frame',
        'nearest', 'nearest-1d', 'window', 'window-rank4'])
def test_resample_matches_jax(method, shape, n_out, add_endpoint, rtol,
                              atol):
    x = np.random.RandomState(len(shape) + n_out).randn(*shape).astype(
        np.float32)
    want = np.asarray(jcore.resample(jnp.asarray(x), n_out, method=method,
                                     add_endpoint=add_endpoint))
    got = tcore.resample(_t(x), n_out, method=method,
                         add_endpoint=add_endpoint).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_resample_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match='method'):
        tcore.resample(torch.zeros(1, 4, 2), 8, method='cubic')
    with pytest.raises(ValueError, match='only upsample'):
        tcore.resample(torch.zeros(1, 8, 2), 4, method='window')


# -- nn: Normalize and the layer list --------------------------------------


def test_normalize_matches_jax():
    j = jnn.Normalize(8)
    params = {'scale': 1.0 + 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                                     (1, 1, 1, 8)),
              'shift': 0.1 * jax.random.normal(jax.random.PRNGKey(2),
                                               (1, 1, 1, 8))}
    x = (np.random.RandomState(0).randn(3, 40, 8) * 2 + 5).astype(
        np.float32)
    t = tnn.Normalize(8)
    load_jax_params(t, _np_tree(params))
    # rtol/atol 1e-5: test_nn_layers.py:23 (f32 statistics, two summation
    # orders over 320 values).
    np.testing.assert_allclose(t(_t(x)).detach().numpy(),
                               np.asarray(j(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    # The statistics pool over the whole sequence: a second half that
    # differs changes the first half's output.
    y = x.copy()
    y[:, 20:] *= 3.0
    assert not np.allclose(t(_t(y)).detach().numpy()[:, :20],
                           t(_t(x)).detach().numpy()[:, :20])


# -- models/sub_modules.py: the dafx22 set ----------------------------------


def _conditioning_small(b=2, t=30, n_synths=3, seed=2):
    rng = np.random.RandomState(seed)
    cond = np.zeros((b, t, n_synths, 2), np.float32)
    cond[:, 5:, 0, 0] = 60.0
    cond[:, 5:9, 0, 1] = 0.8
    cond[1, 12:, 2, 0] = 47.0
    pedal = rng.rand(b, t, 4).astype(np.float32)
    return cond, pedal


def test_one_hot_z_encoder_matches_jax():
    j = jsm.OneHotZEncoder(n_instruments=4, z_dim=5, duration=0.12,
                           frame_rate=250)
    params = j.init(jax.random.PRNGKey(3))
    ids = np.asarray([[1], [7]], np.int32)          # 7: clipped to 3
    want = j.apply(params, jnp.asarray(ids))
    t = tsm.OneHotZEncoder(n_instruments=4, z_dim=5, duration=0.12,
                           frame_rate=250)
    load_jax_params(t, _np_tree(params))
    got = t(torch.from_numpy(ids))
    # Exact: an embedding lookup, resampled from one frame.
    for name, g, w in zip(t.output_keys, got, want):
        assert tuple(g.shape) == (2, 30, w.shape[-1]), name
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w),
                                      name)


def test_context_network_matches_jax():
    n_synths, z_dim = 3, 5
    context_in = 2 * n_synths + 4 + z_dim

    def layers(nn_mod):
        return [nn_mod.Dense(8, context_in, activation='leaky_relu'),
                nn_mod.GRU(12, 8), nn_mod.Normalize(12)]

    j = jsm.ContextNetwork(layers(jnn), out_features=12,
                           output_splits=(('context', 6),))
    params = j.init(jax.random.PRNGKey(4))
    cond, pedal = _conditioning_small(n_synths=n_synths)
    z = np.random.RandomState(4).randn(2, 30, z_dim).astype(np.float32)
    want, = jax.jit(j.apply)(params, jnp.asarray(cond), jnp.asarray(pedal),
                             jnp.asarray(z))
    t = tsm.ContextNetwork(layers(tnn), out_features=12,
                           output_splits=(('context', 6),))
    load_jax_params(t, _np_tree(params))
    got, = t(_t(cond), _t(pedal), _t(z))
    # 1e-5 of peak: GRU and Normalize in f32, two BLAS summation orders
    # (the FiLM context test of test_torch_modules.py).
    _close(got, want, 1e-5, 'context')


def test_monophonic_network_matches_jax():
    splits = (('amplitudes', 1), ('harmonic_distribution', 12),
              ('magnitudes', 8))

    def layers(nn_mod):
        return [nn_mod.Dense(10, 1 + 2 + 6, activation='leaky_relu'),
                nn_mod.GRU(14, 10),
                nn_mod.Dense(14, 14, activation='leaky_relu'),
                nn_mod.Normalize(14)]

    j = jsm.MonophonicNetwork(layers(jnn), out_features=14,
                              output_splits=splits)
    params = j.init(jax.random.PRNGKey(5))
    rng = np.random.RandomState(5)
    cond = (rng.rand(4, 25, 2) * [90.0, 1.0]).astype(np.float32)
    pitch = cond[..., :1].copy()
    context = rng.randn(4, 25, 6).astype(np.float32)
    want = jax.jit(j.apply)(params, jnp.asarray(cond), jnp.asarray(pitch),
                            jnp.asarray(context))
    t = tsm.MonophonicNetwork(layers(tnn), out_features=14,
                              output_splits=splits)
    load_jax_params(t, _np_tree(params))
    got = t(_t(cond), _t(pitch), _t(context))
    for (name, _), g, w in zip(splits, got, want):
        _close(g, w, 1e-5, name)


def _pitches(n=4):
    pitch = np.tile(np.arange(21, 109, dtype=np.float32)[None, :, None],
                    (n, 1, 1))
    pitch[1, ::3] += 0.37                     # fractional (released) pitch
    return pitch


def test_inharmonicity_network_matches_jax():
    j = jsm.InharmonicityNetwork()
    params = j.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(6)
    # Nonzero trainable leaves, so every term of the formula counts.
    params = dict(params,
                  model_specific_weight=jnp.asarray([0.3], jnp.float32),
                  slopes_modifier=jnp.asarray(0.05 * rng.randn(2),
                                              jnp.float32),
                  offsets_modifier=jnp.asarray(0.02 * rng.randn(2),
                                               jnp.float32))
    pitch = _pitches()
    gi = (0.05 * rng.randn(4, 88, 1)).astype(np.float32)
    t = tsm.InharmonicityNetwork()
    load_jax_params(t, _np_tree(params))
    for global_inharm in (None, gi):
        want = j.apply(params, jnp.asarray(pitch),
                       None if global_inharm is None
                       else jnp.asarray(global_inharm))
        got = t(_t(pitch), None if global_inharm is None
                else _t(global_inharm))
        # rtol 1e-5: the JointParametricInharmTuning test's inharmonicity
        # (exp of two libraries).
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(t.regularization().detach()),
                               float(j.regularization(params)), rtol=1e-6)
    # The port's own init is the Rigaud table of the JAX init.
    fresh = tnn.init_weights(tsm.InharmonicityNetwork(), seed=0)
    for name, value in _np_tree(j.init(jax.random.PRNGKey(0))).items():
        np.testing.assert_array_equal(getattr(fresh, name).detach().numpy(),
                                      value, name)


@pytest.mark.parametrize('use_detune', [True, False])
def test_detuner_matches_jax(use_detune):
    j = jsm.Detuner(n_substrings=2, use_detune=use_detune)
    rng = np.random.RandomState(7)
    params = {'layer': {'kernel': jnp.asarray(0.3 * rng.randn(1, 2),
                                              jnp.float32),
                        'bias': jnp.asarray(0.1 * rng.randn(2),
                                            jnp.float32)}}
    pitch = _pitches()
    gd = (0.05 * rng.randn(4, 88, 1)).astype(np.float32)
    want = j.apply(params, jnp.asarray(pitch), jnp.asarray(gd))
    t = tsm.Detuner(n_substrings=2, use_detune=use_detune)
    load_jax_params(t, _np_tree(params))
    got = t(_t(pitch), _t(gd))
    assert tuple(got.shape) == ((4, 88, 2) if use_detune else (4, 88, 1))
    # rtol 1e-6: tanh and pow of two libraries (the joint tuning's f0).
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    # Zero-initialised: the port's init detunes by tanh(global) alone.
    fresh = tnn.init_weights(tsm.Detuner(), seed=0)
    assert torch.count_nonzero(fresh.layer.kernel) == 0


@pytest.mark.parametrize('inference', [True, False],
                         ids=['inference', 'training'])
def test_multi_instrument_reverb_matches_jax(inference):
    j = jsm.MultiInstrumentReverb(n_instruments=3, reverb_duration=1.5,
                                  sample_rate=16000, inference=inference)
    params = j.init(jax.random.PRNGKey(8))
    ids = np.asarray([[2], [0]], np.int32)
    want = j.apply(params, jnp.asarray(ids))
    t = tsm.MultiInstrumentReverb(n_instruments=3, reverb_duration=1.5,
                                  sample_rate=16000, inference=inference)
    load_jax_params(t, _np_tree(params))
    got = t(torch.from_numpy(ids))
    assert tuple(got.shape) == (2, 24000)
    if inference:
        # The decay mask (linspace, exp) of two libraries: rtol 1e-6.
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-13)
        np.testing.assert_array_equal(got.detach().numpy()[:, :16000],
                                      np.asarray(want)[:, :16000])
    else:
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(want))


def test_reverb_regularizer_matches_jax():
    ir = np.random.RandomState(9).randn(3, 500).astype(np.float32)
    want = jlosses.ReverbRegularizer().compute({'reverb_ir': jnp.asarray(ir)})
    got = tlosses.ReverbRegularizer().compute({'reverb_ir': _t(ir)})
    # rtol 1e-6: a sum over 1500 values in two orders.
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the model: phases and configs -----------------------------------------


@pytest.fixture(scope='module')
def jax_dafx22_small():
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    jmodel = jax_get_model('dafx22', duration=0.2, n_synths=4)
    return jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(0))


@pytest.mark.parametrize('first_phase', [True, False, None],
                         ids=['phase1', 'phase2', 'all'])
def test_trainable_mask_matches_jax(jax_dafx22_small, first_phase):
    jmodel, params = jax_dafx22_small
    want = dict(flatten_tree(jax.tree.map(
        bool, jmodel.trainable_mask(params, first_phase=first_phase))))
    model = get_model('dafx22', duration=0.2, n_synths=4, device='cpu')
    got = model.trainable_mask(first_phase)
    assert got == want
    assert set(got) == {n for n, _ in model.named_parameters()}


def test_dafx22_24khz_builds_at_its_widths():
    model = get_model('dafx22_24khz', device='cpu')
    assert model.device.type == 'cpu'
    assert model.sample_rate == 24000 and model.frame_rate == 250
    mono = model.monophonic_network
    assert [n for n, _ in mono.output_splits] == [
        'amplitudes', 'harmonic_distribution', 'magnitudes']
    assert [w for _, w in mono.output_splits] == [1, 128, 96]
    assert model.reverb_model.reverb_length == 36000
    assert model.z_encoder.n_frames == 750
    assert model.processor_group.additive.upsampling == 96


@pytest.mark.parametrize('config,rates', [
    ('maestro_v2', (24000, 250, 16)),
    ('dafx22', (16000, 250, 16)),
    ('dafx22_24khz', (24000, 250, 16))])
def test_config_rates_match_the_built_model(config, rates):
    """The synthesize CLI reads the MIDI at these rates before it builds
    the model for the file's duration."""
    got = config_rates(config)
    model = get_model(config, inference=True, duration=1.0, device='cpu')
    assert (got['sample_rate'], got['frame_rate'], got['n_synths']) == rates
    assert got == {'sample_rate': model.sample_rate,
                   'frame_rate': model.frame_rate,
                   'n_synths': model.n_synths}


def test_dafx22_params_load_from_jax_init(jax_dafx22_small):
    """Every leaf of the JAX init has its parameter in the port, of the same
    shape (load_jax_params raises otherwise), and the v2 tree does not
    load into dafx22."""
    jmodel, params = jax_dafx22_small
    model = get_model('dafx22', duration=0.2, n_synths=4, device='cpu')
    load_jax_params(model, _np_tree(params))
    np.testing.assert_array_equal(
        model.inharm_model.slopes.detach().numpy(),
        np.asarray(params['inharm_model']['slopes']))
    from ddsp_piano_tpu.configs import get_model as jax_get_model
    v2 = jax_get_model('maestro_v2', duration=0.2, n_synths=4)
    with pytest.raises(ValueError, match='missing'):
        load_jax_params(model, _np_tree(jax.jit(v2.init)(
            jax.random.PRNGKey(0))))


# -- the whole render ------------------------------------------------------


def _conditioning():
    """test_torch_render.py's: five notes over 1 s, 16 voices."""
    cond = np.zeros((1, 250, 16, 2), np.float32)
    for voice, (pitch, start) in enumerate([(43, 10), (55, 10), (59, 70),
                                            (62, 130), (67, 190)]):
        cond[:, start:, voice, 0] = pitch
        cond[:, start:start + 8, voice, 1] = 0.7
    return cond


@pytest.fixture(scope='module')
def renders():
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    jmodel = jax_get_model('dafx22', duration=1.0, inference=True)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(42))
    for net in (jmodel.context_network, jmodel.monophonic_network):
        net.apply = jax.jit(net.apply, static_argnames='training')
    cond = _conditioning()
    feats = {'conditioning': jnp.asarray(cond),
             'pedal': jnp.zeros((1, 250, 4)),
             'piano_model': jnp.asarray([[3]], np.int32)}
    rng = jax.random.PRNGKey(7)
    jout = jmodel(params, feats, rng=rng)
    noise = jax.random.uniform(jax.random.fold_in(rng, 1), (16, 16000),
                               jnp.float32, -1.0, 1.0)
    out = {'jax': (np.asarray(jout['audio_synth'])[0],
                   np.asarray(jout['add']['signal'])[0])}
    for oscillator in ('skip', 'full'):
        model = get_model('dafx22', inference=True, duration=1.0,
                          device='cpu', oscillator=oscillator)
        load_jax_params(model, _np_tree(params))
        with torch.inference_mode():
            tout = model({'conditioning': torch.from_numpy(cond),
                          'pedal': torch.zeros(1, 250, 4),
                          'piano_model': torch.tensor([[3]])},
                         noise=torch.from_numpy(np.array(noise)))
        out[oscillator] = (tout['audio_synth'][0].numpy(),
                           tout['add']['signal'][0].numpy())
        if oscillator == 'skip':
            out['f0'] = (tout['f0_hz'].numpy(), np.asarray(jout['f0_hz']))
    return out


@pytest.mark.parametrize('oscillator', ['skip', 'full'])
@pytest.mark.parametrize('stem', [0, 1], ids=['wet', 'dry'])
def test_dafx22_render_matches_jax(renders, oscillator, stem):
    got, want = renders[oscillator][stem], renders['jax'][stem]
    assert got.shape == want.shape == (16000,)
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > 0.05
    # 1.1e-4 of peak, the v2 render's (tests/test_torch_render.py): the
    # floor is the JAX package's float32 phase cumsum.
    err = np.abs(got - want).max() / peak
    assert err <= 1.1e-4, err


def test_dafx22_substring_frequencies_match_jax(renders):
    """Detuner (through NoteRelease and the z encoder) puts the two
    substrings where JAX eager puts them, bit for bit: the frequency path
    rounds once from float64. At init the Detuner's dense is zero and both
    substrings share the global detuning, so they coincide."""
    got, want = renders['f0']
    assert got.shape == want.shape == (16, 1, 250, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 0], got[..., 1])
    assert (got[0, 0, 20:, 0] != 440.0 * 2.0 ** ((43 - 69) / 12.0)).all()


# -- the synthesize CLI ----------------------------------------------------


@pytest.mark.parametrize('config,oscillator,rate', [
    ('dafx22', 'skip', 16000), ('dafx22', 'full', 16000),
    ('dafx22_24khz', 'skip', 24000)])
def test_synthesize_cli_dafx22_on_cpu(tmp_path, config, oscillator, rate):
    """The CLI reads the MIDI first and builds the model for the file's
    duration (0.5 s + 0.2 s of warm-up here), at the config's rate."""
    import os

    from ddsp_piano_torch import synthesize_midi_file as cli

    demo = os.path.join(os.path.dirname(__file__), '..', 'examples',
                        'demo.mid')
    out = str(tmp_path / 'demo.wav')
    result = cli.main(cli.process_args(
        ['-c', config, '-d', '0.5', '-wu', '0.2', '--oscillator',
         oscillator, '--device', 'cpu', demo, out]))
    assert result['sample_rate'] == rate
    assert result['audio'].shape == (rate // 2,)
    assert np.isfinite(result['audio']).all()
    assert np.sqrt(np.mean(result['dry'] ** 2)) > 1e-4
    assert os.path.exists(out)
