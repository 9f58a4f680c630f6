"""The whole slice: maestro_v2 at full width, JAX package vs port.

Both sides render 1 s of the conditioning of test_golden_render.py:53-77
with the PRNGKey(42) init weights; the port gets them through
load_jax_params and the JAX noise draw through its injected-noise input.

The JAX side runs op by op (no jit) from the tuning model on. Under jit
XLA fuses the elementwise chains and contracts multiply-adds, which moves
partial frequencies by an ulp; a frequency error grows into a phase error
2 pi df t, so the JAX package's own jitted and eager renders differ by
1.6e-3 of peak. Eager, each op rounds as the port's does.
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

from ddsp_piano_torch.configs import get_model  # noqa: E402
from ddsp_piano_torch.params import load_jax_params  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden', 'v2_render.npz')
DEMO_MIDI = os.path.join(os.path.dirname(__file__), '..', 'examples',
                         'demo.mid')


def _conditioning():
    cond = np.zeros((1, 250, 16, 2), np.float32)
    for voice, (pitch, start) in enumerate([(43, 10), (55, 10), (59, 70),
                                            (62, 130), (67, 190)]):
        cond[:, start:, voice, 0] = pitch
        cond[:, start:start + 8, voice, 1] = 0.7
    return cond


@pytest.fixture(scope='module')
def renders():
    from ddsp_piano_tpu.configs import get_model as jax_get_model

    jmodel = jax_get_model('maestro_v2', duration=1.0, inference=True)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(42))
    # The two GRU networks run jitted (their outputs carry no phase), the
    # rest op by op.
    for net in (jmodel.context_network, jmodel.monophonic_network):
        net.apply = jax.jit(net.apply, static_argnames='training')
    cond = _conditioning()
    feats = {'conditioning': jnp.asarray(cond),
             'pedal': jnp.zeros((1, 250, 4)),
             'piano_model': jnp.asarray([[3]], np.int32)}
    rng = jax.random.PRNGKey(7)
    jout = jmodel(params, feats, rng=rng)
    # The noise synth's draw inside VectorizedPolyphonicProcessorGroup.
    noise = jax.random.uniform(jax.random.fold_in(rng, 1), (16, 24000),
                               jnp.float32, -1.0, 1.0)

    model = get_model('maestro_v2', inference=True, duration=1.0,
                      device='cpu')
    load_jax_params(model, jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        tout = model({'conditioning': torch.from_numpy(cond),
                      'pedal': torch.zeros(1, 250, 4),
                      'piano_model': torch.tensor([[3]])},
                     noise=torch.from_numpy(np.array(noise)))
    return {
        'jax': (np.asarray(jout['audio_synth'])[0],
                np.asarray(jout['add']['signal'])[0]),
        'port': (tout['audio_synth'][0].numpy(),
                 tout['add']['signal'][0].numpy()),
    }


@pytest.mark.parametrize('stem', [0, 1], ids=['wet', 'dry'])
def test_v2_render_matches_jax(renders, stem):
    got, want = renders['port'][stem], renders['jax'][stem]
    assert got.shape == want.shape == (24000,)
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > 0.1
    # 1.1e-4 of peak; measured 1.007e-4 (wet) and 9.80e-5 (dry). The
    # partial frequencies of both sides are bit-equal here, so the floor is
    # the JAX package's float32 phase cumsum: it reaches 250 * 2 pi, where
    # one ulp is 1.2e-4 rad, for every partial. The port accumulates the
    # phase in float64 (ops/oscillator.py).
    err = np.abs(got - want).max() / peak
    assert err <= 1.1e-4, err


@pytest.mark.parametrize('stem', ['audio', 'dry'])
def test_v2_render_within_golden_spectral_budget(renders, stem):
    from ddsp_piano_tpu.ops import spectral

    golden = np.load(GOLDEN)
    got = renders['port'][0 if stem == 'audio' else 1]
    loss = float(spectral.multi_scale_spectral_loss(
        golden[stem][None], got[None], logmag_weight=1.0))
    # test_golden_render.py:91-98.
    assert loss < 0.15, loss


def test_synthesize_cli_on_cpu(tmp_path):
    from ddsp_piano_torch import synthesize_midi_file as cli
    from ddsp_piano_torch.data import audio_io

    out = str(tmp_path / 'demo.wav')
    result = cli.main(cli.process_args(
        ['-d', '1', '-wu', '0.5', '-u', '--device', 'cpu', DEMO_MIDI, out]))
    assert result['sample_rate'] == 24000
    assert result['audio'].shape == (int(1.0 * 24000),)
    assert np.isfinite(result['audio']).all()
    assert np.sqrt(np.mean(result['dry'] ** 2)) > 1e-4
    data, rate = audio_io.read_wav(out)
    assert rate == 24000 and data.shape == (24000, 1)
    assert os.path.exists(out + '_unreverbed.wav')


@pytest.mark.parametrize('flag', [['--streaming', '--chunk_seconds',
                                   '0.001'], ['--ckpt', 'x']])
def test_synthesize_cli_refuses_unported_options(tmp_path, flag):
    """A streaming chunk below one frame period raises, as the JAX CLI
    does (synthesize_midi_file.py:131-157); a --ckpt path that holds no
    checkpoint raises a clear error."""
    from ddsp_piano_torch import synthesize_midi_file as cli

    error, match = ((FileNotFoundError, "'x' holds no checkpoint")
                    if flag[0] == '--ckpt'
                    else (SystemExit, 'below one frame'))
    with pytest.raises(error, match=match):
        cli.main(cli.process_args(
            flag + ['--device', 'cpu', DEMO_MIDI, str(tmp_path / 'o.wav')]))


def test_midi_conditioning_copy_matches_jax_package():
    from ddsp_piano_torch.data.io import load_midi_as_conditioning as port
    from ddsp_piano_tpu.data.io import load_midi_as_conditioning as ref

    got = port(DEMO_MIDI, duration=3.0, warm_up_duration=0.5)
    want = ref(DEMO_MIDI, duration=3.0, warm_up_duration=0.5)
    assert got['duration'] == want['duration']
    for k in ('conditioning', 'pedal'):
        np.testing.assert_array_equal(got[k], want[k])
