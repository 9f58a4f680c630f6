"""The five configurations ported last through the port's entry points, on
the CPU: the synthesize CLI (either oscillator where the synth has one),
streaming of the three that stream with the pedal-only context network,
the surrogate synth or the standalone FDN reverb (streamed against
one-shot, at every chunk boundary, against the JAX package's streamer,
per-chunk statistics, the FDN IR made once, the CLI's --streaming), the
port's own checkpoint (ckpt.pt) through restore_params and --ckpt, and the
evaluation sweep. (The train CLI: tests/test_torch_configs_training.py.)
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

from ddsp_piano_torch import configs  # noqa: E402
from ddsp_piano_torch import synthesize_midi_file as cli  # noqa: E402
from ddsp_piano_torch.configs import config_rates, get_model  # noqa: E402
from ddsp_piano_torch.models.streaming import (  # noqa: E402
    StreamingSynthesizer)
from ddsp_piano_torch.params import load_jax_params  # noqa: E402
from test_torch_serving import _RoundedTanhJnp  # noqa: E402
from test_torch_streaming import (_jax_streamer_class,  # noqa: E402
                                  _recording_noise)

DEMO_MIDI = os.path.join(os.path.dirname(__file__), '..', 'examples',
                         'demo.mid')
NEW_CONFIGS = ('enstdkcl_8khz', 'enstdkcl_32khz', 'multi_instruments',
               'surrogate', 'maestro_v2_regularized')
# The configurations that stream the pedal-only SimpleContextNet and the
# standalone FDN (enstdkcl_8khz), the FDN (enstdkcl_32khz) and the
# surrogate synth (ROADMAP A.4).
STREAMED = ('enstdkcl_8khz', 'enstdkcl_32khz', 'surrogate')
SMALL = {'n_synths': 4, 'n_harmonics': 16, 'n_noise_bands': 16}
CHUNK = 125
# Streamed against one-shot: tests/test_streaming.py:93-98 (0.02 of peak,
# correlation 0.999). At each chunk boundary, where an off-by-one frame
# would click, 1e-5 of peak (measured 5.5e-7 over whole renders: the
# float64 phase carry rounds once a chunk, the one-shot cumsum once).
STREAM_TOL = 0.02
STREAM_MIN_CORR = 0.999
BOUNDARY_TOL = 1e-5
# Against the JAX package's streamer: the whole render's 1.1e-4 of peak.
RENDER_TOL = 1.1e-4


@pytest.mark.parametrize('config,oscillator', [
    ('enstdkcl_8khz', 'skip'), ('enstdkcl_8khz', 'full'),
    ('enstdkcl_32khz', 'skip'), ('multi_instruments', 'full'),
    ('surrogate', 'skip'), ('maestro_v2_regularized', 'skip')])
def test_synthesize_cli_on_cpu(tmp_path, config, oscillator):
    """The CLI builds each config for the file's duration (0.5 s + 0.2 s
    of warm-up here) at its rate, with either oscillator for the
    MultiInharmonic configs."""
    out = str(tmp_path / 'demo.wav')
    result = cli.main(cli.process_args(
        ['-c', config, '-d', '0.5', '-wu', '0.2', '--oscillator',
         oscillator, '--device', 'cpu', DEMO_MIDI, out]))
    rate = config_rates(config)['sample_rate']
    assert result['sample_rate'] == rate
    assert result['audio'].shape == (rate // 2,)
    assert np.isfinite(result['audio']).all()
    assert np.sqrt(np.mean(result['dry'] ** 2)) > 1e-4
    assert os.path.exists(out)
    if oscillator == 'full':
        assert result['model'].processor_group.additive.oscillator == 'full'


def test_synthesize_cli_refuses_full_oscillator_for_surrogate(tmp_path):
    with pytest.raises(ValueError, match='surrogate model renders'):
        cli.main(cli.process_args(
            ['-c', 'surrogate', '-d', '0.5', '--oscillator', 'full',
             '--device', 'cpu', DEMO_MIDI, str(tmp_path / 'o.wav')]))


def _stream_features(n_frames=500, n_synths=4, piano=0):
    """Four notes across chunk boundaries (one released at a boundary, one
    inside a chunk), a pedal move."""
    cond = torch.zeros(1, n_frames, n_synths, 2)
    for voice, (pitch, start, end) in enumerate([(48, 10, 380), (55, 60, 250),
                                                 (64, 130, 490),
                                                 (71, 200, 330)]):
        end = min(end, n_frames)
        cond[:, start:end, voice, 0] = pitch
        cond[:, start:start + 6, voice, 1] = 0.6
    pedal = torch.zeros(1, n_frames, 4)
    pedal[:, 100:300, 0] = 0.7
    return {'conditioning': cond, 'pedal': pedal,
            'piano_model': torch.tensor([[piano]])}


@pytest.mark.parametrize('driver', ['synthesize', 'synthesize_scanned'])
@pytest.mark.parametrize('config', STREAMED)
def test_streamed_config_as_one_shot(config, driver):
    """Both drivers against the one-shot forward on one full-length draw,
    wet and dry: within 0.02 of peak and correlation 0.999 but the flushed
    last frame, and within 1e-5 of peak in the frame either side of every
    chunk boundary."""
    model = get_model(config, inference=True, duration=2.0, device='cpu',
                      **SMALL)
    feats = _stream_features()
    up = model.sample_rate // model.frame_rate
    noise = 2.0 * torch.rand((4, 500 * up),
                             generator=torch.Generator().manual_seed(0)) - 1
    with torch.inference_mode():
        one = model(feats, noise=noise)
        wet, dry = getattr(StreamingSynthesizer(model, CHUNK), driver)(
            feats, noise=noise, return_dry=True)
    for got, want in ((wet, one['audio_synth']), (dry, one['add']['signal'])):
        a, b = want[0, :-up].numpy(), got[0, :-up].numpy()
        peak = np.abs(a).max()
        assert peak > 1e-2
        assert np.abs(b - a).max() / peak <= STREAM_TOL
        assert np.corrcoef(a, b)[0, 1] > STREAM_MIN_CORR
        for edge in range(CHUNK * up, 500 * up - up, CHUNK * up):
            window = slice(edge - up, edge + up)
            assert np.abs(b[window] - a[window]).max() / peak \
                <= BOUNDARY_TOL, edge


@pytest.mark.parametrize('config', ['enstdkcl_8khz', 'enstdkcl_32khz'])
def test_fdn_ir_made_once_and_equal_to_one_shot(config, monkeypatch):
    """The standalone FDN's IR is synthesised once a render by either
    driver (not once a chunk), and equals the one-shot forward's bit for
    bit."""
    model = get_model(config, inference=True, duration=2.0, device='cpu',
                      **SMALL)
    reverb = model.processor_group.reverb
    irs = []
    original = reverb.trained_ir
    monkeypatch.setattr(reverb, 'trained_ir',
                        lambda: irs.append(original()) or irs[-1])
    feats = _stream_features()
    streamer = StreamingSynthesizer(model, CHUNK)
    with torch.inference_mode():
        model(feats)
        assert len(irs) == 1
        streamer.synthesize(feats)
        assert len(irs) == 2
        streamer.synthesize_scanned(feats)
        assert len(irs) == 3
    assert irs[0].shape == (1, 2 * model.sample_rate)
    for ir in irs[1:]:
        torch.testing.assert_close(ir, irs[0], rtol=0, atol=0)


@pytest.mark.parametrize('config,exact', [('enstdkcl_8khz', True),
                                          ('enstdkcl_8khz', False),
                                          ('surrogate', True)],
                         ids=['enstdkcl_8khz', 'enstdkcl_8khz-per_chunk',
                              'surrogate'])
def test_streamed_config_matches_jax(config, exact, monkeypatch):
    """The port's streamer against the JAX package's (synthesize, 250
    frames at 125-frame chunks, its per-chunk draws injected, its phase
    sums in float64 and its tuning's tanh correctly rounded, as
    tests/test_torch_streaming.py and tests/test_torch_serving.py widen
    them), with whole-file statistics and, for enstdkcl_8khz, per-chunk
    ones (exact_normalize=False): wet and dry within the render's 1.1e-4
    of peak (measured at most 2.3e-6). enstdkcl_8khz holds the
    SimpleContextNet and the standalone FDN, the surrogate its synth:
    enstdkcl_32khz adds no part of its own (measured 1.3e-6, not kept:
    op by op a config's first JAX render costs ~25 s of this file)."""
    from ddsp_piano_tpu.configs import get_model as jax_get_model
    from ddsp_piano_tpu.models import sub_modules as jsm

    js_class = _jax_streamer_class(monkeypatch, 'float64')
    monkeypatch.setattr(jsm, 'jnp', _RoundedTanhJnp())
    jmodel = jax_get_model(config, duration=1.0, inference=True, **SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(5))
    model = get_model(config, inference=True, duration=1.0, device='cpu',
                      **SMALL)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    feats = _stream_features(n_frames=250)
    draws = []
    restore = _recording_noise(jmodel, draws)
    jstreamer = js_class(jmodel, chunk_frames=CHUNK, exact_normalize=exact)
    # The statistics sweeps carry no phase: compiled, as the JAX CLI runs
    # them (op by op they take most of the test's time).
    n_chunks = 250 // CHUNK
    jstreamer._stats_fns[n_chunks] = jax.jit(
        lambda p, f: jstreamer._norm_stats_all(p, f, n_chunks))
    try:
        want = jstreamer.synthesize(
            params, {k: v.numpy() for k, v in feats.items()},
            rng=jax.random.PRNGKey(11), return_dry=True)
    finally:
        restore()
    streamer = StreamingSynthesizer(model, CHUNK, exact_normalize=exact)
    assert streamer._norm_slots == jstreamer._norm_slots != []
    with torch.inference_mode():
        got = streamer.synthesize(feats, noise=draws, return_dry=True)
    for stem, g, w in zip(('wet', 'dry'), got, want):
        peak = np.abs(w[0]).max()
        assert peak > 1e-2, stem
        err = np.abs(g[0].numpy() - w[0]).max() / peak
        print(f"\n{config} exact={exact} {stem}: {err:.3g} of peak")
        assert err <= RENDER_TOL, (stem, err)


@pytest.mark.parametrize('config', STREAMED)
def test_streaming_cli_renders_each_config(tmp_path, monkeypatch, config):
    """synthesize_midi_file --streaming for the three configs
    (16 voices, 16 harmonics, 0.5 s at 0.4 s chunks): the file's samples,
    finite, 2 chunks."""
    original = configs.get_model
    monkeypatch.setattr(configs, 'get_model', lambda *a, **k: original(
        *a, **{'n_harmonics': 16, 'n_noise_bands': 16, **k}))
    out = str(tmp_path / 'o.wav')
    result = cli.main(cli.process_args(
        ['-c', config, '--streaming', '--chunk_seconds', '0.4', '-d', '0.5',
         '-wu', '0.2', '--device', 'cpu', DEMO_MIDI, out]))
    rate = config_rates(config)['sample_rate']
    assert result['audio'].shape == (rate // 2,)
    assert np.isfinite(result['audio']).all()
    assert np.sqrt(np.mean(result['dry'] ** 2)) > 1e-4
    assert result['chunks'] == 2
    assert os.path.exists(out)


def test_multi_instruments_streams_as_one_shot():
    """multi_instruments streams (normalized-pitch context, deep mono
    network, pitch-table inharmonicity, wet-only reverb): the streamed
    render against the one-shot forward on one full-length draw, within
    tests/test_streaming.py:93-98's 0.02 of peak and correlation 0.999,
    all but the flushed last frame."""
    model = get_model('multi_instruments', inference=True, duration=2.0,
                      device='cpu', n_synths=4, n_harmonics=16,
                      n_noise_bands=16)
    with torch.no_grad():
        # An audible IR: the initial one is 1e-6 normal.
        model.reverb_model.reverb_dict.embeddings.mul_(1e4)
    cond = torch.zeros(1, 500, 4, 2)
    for voice, (pitch, start, end) in enumerate([(48, 10, 380), (55, 60, 200),
                                                 (64, 130, 490),
                                                 (71, 260, 330)]):
        cond[:, start:end, voice, 0] = pitch
        cond[:, start:start + 6, voice, 1] = 0.6
    feats = {'conditioning': cond, 'pedal': torch.zeros(1, 500, 4),
             'piano_model': torch.tensor([[2]])}
    noise = 2.0 * torch.rand((4, 500 * 64),
                             generator=torch.Generator().manual_seed(0)) - 1
    with torch.inference_mode():
        one = model(feats, noise=noise)
        wet, dry = StreamingSynthesizer(model, 125).synthesize_scanned(
            feats, noise=noise, return_dry=True)
    for got, want in ((wet, one['audio_synth']), (dry, one['add']['signal'])):
        a, b = want[0, :-64].numpy(), got[0, :-64].numpy()
        assert np.abs(b - a).max() / np.abs(a).max() <= 0.02
        assert np.corrcoef(a, b)[0, 1] > 0.999


@pytest.mark.parametrize('config', NEW_CONFIGS)
def test_ckpt_render_restores_each_config(tmp_path, config):
    """A ckpt.pt of each config (the trainer's format) through
    synthesize_midi_file --ckpt: the model's parameters equal the saved
    ones, trainable FDN reverb included (test_torch_checkpoints.py's
    maestro_v2 case also holds the render against an in-process one)."""
    trained = get_model(config, device='cpu', seed=14, duration=3.0)
    directory = tmp_path / 'last_iter'
    os.makedirs(directory)
    torch.save({'model': trained.state_dict()}, str(directory / 'ckpt.pt'))
    common = ['-c', config, '-d', '0.5', '-wu', '0.2', '--seed', '3',
              '--device', 'cpu', DEMO_MIDI]
    got = cli.main(cli.process_args(['--ckpt', str(directory)] + common
                                    + [str(tmp_path / 'ckpt.wav')]))
    want = trained.state_dict()
    params = dict(got['model'].named_parameters())
    assert sorted(params) == sorted(n for n, _ in trained.named_parameters())
    for name, value in params.items():
        torch.testing.assert_close(value.detach(), want[name], rtol=0,
                                   atol=0, msg=name)
    assert np.isfinite(got['audio']).all()


def _eval_segments(n, sample_rate, n_synths=16, seconds=0.5):
    """n batch-1 segments in the test split's format at the config's rate:
    a few held notes and a noisy target."""
    segs = []
    for i in range(n):
        rng = np.random.RandomState(i)
        frames, samples = int(seconds * 250), int(seconds * sample_rate)
        cond = np.zeros((1, frames, n_synths, 2), np.float32)
        for voice in range(rng.randint(1, 5)):
            start = rng.randint(0, frames // 2)
            cond[0, start:, voice, 0] = rng.randint(36, 84)
            cond[0, start:start + 4, voice, 1] = rng.uniform(0.3, 0.9)
        segs.append({
            'conditioning': cond,
            'pedal': rng.uniform(0, 1, (1, frames, 4)).astype(np.float32),
            'audio': (0.1 * rng.randn(1, samples)).astype(np.float32),
            'piano_model': np.asarray([[i % 10]], np.int32),
            'polyphony': np.zeros((1, frames, 1), np.int32),
            'filename': np.asarray([[f'track_{i}']]),
        })
    return segs


@pytest.mark.parametrize('config', NEW_CONFIGS)
def test_evaluate_cli_on_cpu(tmp_path, monkeypatch, config):
    """evaluate_model -c <config> --duration 0.5 -b 2 over three segments
    of a test split (the dataset stubbed): one finite, positive loss a
    segment in the CSV."""
    import csv

    from ddsp_piano_torch import evaluate_model
    from ddsp_piano_torch.data import pipeline

    segs = _eval_segments(3, config_rates(config)['sample_rate'])
    monkeypatch.setattr(pipeline, 'get_test_dataset',
                        lambda *a, **k: iter(list(segs)))
    out_dir = str(tmp_path / 'eval')
    result = evaluate_model.main(evaluate_model.process_args(
        ['-c', config, '--duration', '0.5', '--batch_size', '2',
         '--device', 'cpu', 'data', out_dir]))
    with open(os.path.join(out_dir, 'spectral.csv'), newline='') as f:
        rows = list(csv.DictReader(f))
    assert result['batches'] == 2
    assert [r['filename'] for r in rows] == ['track_0', 'track_1',
                                             'track_2']
    losses = np.array([float(r['loss_val']) for r in rows])
    assert np.isfinite(losses).all() and (losses > 0).all()
