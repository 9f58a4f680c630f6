"""The five configurations ported last through the port's entry points, on
the CPU: the synthesize CLI (either oscillator where the synth has one),
streaming's refusal of what it does not port, the port's own checkpoint
(ckpt.pt) through restore_params and --ckpt, and the evaluation sweep.
(The train CLI: tests/test_torch_configs_training.py.)
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

from ddsp_piano_torch import synthesize_midi_file as cli  # noqa: E402
from ddsp_piano_torch.configs import config_rates, get_model  # noqa: E402
from ddsp_piano_torch.models.streaming import (  # noqa: E402
    StreamingSynthesizer)

DEMO_MIDI = os.path.join(os.path.dirname(__file__), '..', 'examples',
                         'demo.mid')
NEW_CONFIGS = ('enstdkcl_8khz', 'enstdkcl_32khz', 'multi_instruments',
               'surrogate', 'maestro_v2_regularized')
# The configurations whose streaming is not ported (ROADMAP A.4).
NOT_STREAMED = {'enstdkcl_8khz': 'SimpleContextNet',
                'enstdkcl_32khz': 'FeedbackDelayNetwork reverb',
                'surrogate': 'SurrogateAdditive additive synth'}


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


@pytest.mark.parametrize('config', sorted(NOT_STREAMED))
def test_streaming_refuses_unported_configs(tmp_path, config):
    """One clear ValueError, from the library and from the CLI, naming what
    is not ported."""
    model = get_model(config, inference=True, duration=0.5, device='cpu',
                      n_synths=4, n_harmonics=16)
    with pytest.raises(ValueError, match=NOT_STREAMED[config]):
        StreamingSynthesizer(model, chunk_frames=125)
    with pytest.raises(ValueError, match='Streaming is not ported'):
        cli.main(cli.process_args(
            ['-c', config, '--streaming', '--chunk_seconds', '0.4', '-d',
             '0.5', '--device', 'cpu', DEMO_MIDI, str(tmp_path / 'o.wav')]))


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
