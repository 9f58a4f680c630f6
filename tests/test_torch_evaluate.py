"""The port's evaluation sweep, against the JAX package's, on the CPU.

Counterparts of tests/test_evaluate_cli.py: the per-element spectral
loss, the padded batching, the CSV's independence from the batch size and
one wav per segment; then the per-segment losses against the JAX
package's build_segment_eval_fn with its noise draws injected, and the
test split against the JAX pipeline's.
"""

import csv
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

from ddsp_piano_torch import configs  # noqa: E402
from ddsp_piano_torch import evaluate_model  # noqa: E402
from ddsp_piano_torch.configs import get_model  # noqa: E402
from ddsp_piano_torch.data import pipeline  # noqa: E402
from ddsp_piano_torch.models.losses import SpectralLoss  # noqa: E402
from ddsp_piano_torch.params import load_jax_params  # noqa: E402
from ddsp_piano_torch.training.evaluation import (  # noqa: E402
    build_segment_eval_fn)

DURATION = 0.5
N_SYNTHS = 4


def test_compute_per_element_matches_singleton_batches():
    rng = np.random.RandomState(0)
    target = torch.from_numpy(rng.randn(3, 4000).astype(np.float32))
    synth = torch.from_numpy(rng.randn(3, 4000).astype(np.float32))
    loss = SpectralLoss(fft_sizes=(512, 256, 64), logmag_weight=1.0)
    per_elem = loss.compute_per_element(target, synth).numpy()
    singles = [float(loss.compute({'audio': target[i:i + 1],
                                   'audio_synth': synth[i:i + 1]}))
               for i in range(3)]
    assert per_elem.shape == (3,)
    np.testing.assert_allclose(per_elem, singles, rtol=1e-6)


def test_compute_per_element_matches_jax():
    from ddsp_piano_tpu.models.losses import SpectralLoss as JaxSpectralLoss

    rng = np.random.RandomState(1)
    target = rng.randn(3, 4000).astype(np.float32)
    synth = rng.randn(3, 4000).astype(np.float32)
    kwargs = dict(fft_sizes=(2048, 1024, 512, 256, 128, 64),
                  logmag_weight=1.0)
    got = SpectralLoss(**kwargs).compute_per_element(
        torch.from_numpy(target), torch.from_numpy(synth)).numpy()
    want = np.asarray(JaxSpectralLoss(**kwargs).compute_per_element(
        jnp.asarray(target), jnp.asarray(synth)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _segments(n, seed0=0):
    """n batch-1 segments in the test split's format: 0.5 s at 16 kHz,
    4 voices, a few held notes and a noisy target."""
    segs = []
    for i in range(n):
        rng = np.random.RandomState(seed0 + i)
        frames, samples = int(DURATION * 250), int(DURATION * 16000)
        cond = np.zeros((1, frames, N_SYNTHS, 2), np.float32)
        for voice in range(rng.randint(1, N_SYNTHS + 1)):
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


def _small_dafx22(seed=0):
    return get_model('dafx22', inference=True, duration=DURATION,
                     device='cpu', seed=seed, n_synths=N_SYNTHS)


def test_batched_segments_pads_remainder():
    segs = _segments(5)
    groups = list(evaluate_model.batched_segments(iter(segs), 4))
    assert len(groups) == 2
    (b0, m0, v0), (b1, m1, v1) = groups
    assert v0 == 4 and v1 == 1
    assert b0['audio'].shape[0] == 4 and b1['audio'].shape[0] == 4
    assert [m['filename'] for m in m0] == [f'track_{i}' for i in range(4)]
    assert [m['filename'] for m in m1] == ['track_4']
    assert [m['piano_model'] for m in m0] == [0, 1, 2, 3]
    # Pad rows repeat the final segment.
    for row in (1, 2, 3):
        np.testing.assert_array_equal(b1['audio'][row], b1['audio'][0])
    assert 'filename' not in b1


@pytest.fixture()
def tiny_eval_env(monkeypatch):
    segs = _segments(5)
    monkeypatch.setattr(pipeline, 'get_test_dataset',
                        lambda *a, **k: iter(list(segs)))
    monkeypatch.setattr(configs, 'get_model',
                        lambda name, **kw: _small_dafx22())
    return segs


def _read_csv(path):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def _run_eval(tmp_path, batch_size, out_name, extra=()):
    out_dir = str(tmp_path / out_name)
    args = evaluate_model.process_args(
        ['--batch_size', str(batch_size), '--duration', str(DURATION),
         '--device', 'cpu', '-c', 'tiny', *extra, 'data', out_dir])
    result = evaluate_model.main(args)
    return result, _read_csv(os.path.join(out_dir, 'spectral.csv'))


def test_csv_contents_independent_of_batch_size(tmp_path, tiny_eval_env):
    r1, rows1 = _run_eval(tmp_path, 1, 'b1')
    r4, rows4 = _run_eval(tmp_path, 4, 'b4')
    assert r1['batches'] == 5 and r4['batches'] == 2
    assert len(rows1) == len(rows4) == 5
    assert list(rows1[0]) == ['filename', 'piano_model', 'loss_val']
    assert [r['filename'] for r in rows1] == [r['filename'] for r in rows4]
    assert [r['piano_model'] for r in rows1] == [
        r['piano_model'] for r in rows4] == [str(i) for i in range(5)]
    loss1 = np.array([float(r['loss_val']) for r in rows1])
    loss4 = np.array([float(r['loss_val']) for r in rows4])
    assert np.isfinite(loss1).all() and (loss1 > 0).all()
    np.testing.assert_allclose(loss4, loss1, rtol=1e-4)
    # The periodic CSV was written after the first batch.
    partial = _read_csv(str(tmp_path / 'b4' / 'spectral_losses.csv'))
    assert [r['filename'] for r in partial] == [f'track_{i}'
                                                for i in range(4)]


def test_get_wav_writes_one_file_per_segment(tmp_path, monkeypatch):
    """Every segment of a track shares its filename; the writer tells them
    apart by the global segment index."""
    segs = _segments(5)
    for seg in segs:
        seg['filename'] = np.asarray([['same_track']])
    monkeypatch.setattr(pipeline, 'get_test_dataset',
                        lambda *a, **k: iter(list(segs)))
    monkeypatch.setattr(configs, 'get_model',
                        lambda name, **kw: _small_dafx22())
    _run_eval(tmp_path, 2, 'wavs', extra=['--get_wav'])
    wavs = sorted(os.listdir(str(tmp_path / 'wavs' / 'wav')))
    assert wavs == [f'same_track_{i:04d}.wav' for i in range(5)], wavs


def test_evaluate_cli_loads_the_checkpoint(tmp_path, tiny_eval_env):
    """--ckpt goes through restore_params: the losses are those of the
    checkpoint's weights."""
    from ddsp_piano_torch.training.trainer import Trainer

    trained = _small_dafx22(seed=4)
    ckpt = Trainer(trained, first_phase=True).save(str(tmp_path / 'ckpt'))
    _, initial = _run_eval(tmp_path, 4, 'initial')
    _, restored = _run_eval(tmp_path, 4, 'restored', extra=['--ckpt', ckpt])
    eval_fn = build_segment_eval_fn(trained)
    batch, _, _ = next(evaluate_model.batched_segments(
        iter(tiny_eval_env), 4))
    want, _ = eval_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                      [0, 1, 2, 3])
    got = [float(r['loss_val']) for r in restored[:4]]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)
    assert got != [float(r['loss_val']) for r in initial[:4]]


def test_segment_losses_match_jax():
    """The port's build_segment_eval_fn against the JAX package's on the
    same weights and segments, with the JAX draws of each segment
    (fold_in(PRNGKey(0), index), then the noise synth's fold_in(., 1)
    uniform) injected: within rtol 1e-4. The JAX sweep runs jitted, as its
    CLI runs it."""
    from ddsp_piano_tpu.configs import get_model as jax_get_model
    from ddsp_piano_tpu.training.evaluation import (
        build_segment_eval_fn as jax_eval_fn)

    jmodel = jax_get_model('dafx22', duration=DURATION, inference=True,
                           n_synths=N_SYNTHS)
    params = jmodel.init(jax.random.PRNGKey(5))
    model = load_jax_params(_small_dafx22(),
                            jax.tree.map(np.asarray, params))
    segs = _segments(4, seed0=10)
    batch, _, _ = next(evaluate_model.batched_segments(iter(segs), 4))
    seg_indices = np.arange(7, 11)
    want, want_audio = jax.jit(jax_eval_fn(jmodel))(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(seg_indices))
    n_samples = batch['audio'].shape[-1]
    noise = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), i), 1),
        (N_SYNTHS, n_samples), jnp.float32, -1.0, 1.0)) for i in seg_indices])
    got, audio = build_segment_eval_fn(model)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, seg_indices,
        noise=torch.from_numpy(noise))
    assert got.shape == (4,) and audio.shape == (4, n_samples)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    peak = np.abs(np.asarray(want_audio)).max()
    assert np.abs(audio.numpy() - np.asarray(want_audio)).max() <= 1e-3 * peak


def test_segment_noise_follows_the_segment_index():
    """A segment's draw depends on its index alone, not on its row."""
    from ddsp_piano_torch.training.evaluation import segment_noise

    a = segment_noise([3, 4, 5], 2, 64, 'cpu')
    b = segment_noise([5, 3], 2, 64, 'cpu')
    torch.testing.assert_close(a[2], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[0], b[1], rtol=0, atol=0)
    assert a.min() >= -1.0 and a.max() < 1.0
    assert not torch.equal(a[0], a[1])


def _write_test_maestro(root, sample_rate=16000, seconds=2.3):
    """maestro-v3.0.0.csv with a train row and two test rows over one MIDI
    file and one wav."""
    from ddsp_piano_torch.data import audio_io, midi

    os.makedirs(root, exist_ok=True)
    notes = [midi.Note(48 + 7 * (i % 3), 80, 0.3 * i, 0.3 * i + 0.5)
             for i in range(6)]
    midi.write_midi(os.path.join(root, 'track.midi'), notes)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    audio_io.write_wav(os.path.join(root, 'track.wav'),
                       0.2 * np.sin(2 * np.pi * 196.0 * t), sample_rate)
    with open(os.path.join(root, 'maestro-v3.0.0.csv'), 'w') as f:
        f.write('canonical_composer,canonical_title,split,year,'
                'midi_filename,audio_filename,duration\n')
        for split, year in (('train', 2018), ('test', 2017), ('test', 2015)):
            f.write(f'Nobody,Etude,{split},{year},track.midi,track.wav,'
                    f'{seconds}\n')
    return root


def test_test_dataset_matches_jax_package(tmp_path):
    from ddsp_piano_tpu.data import pipeline as jpipe

    root = _write_test_maestro(str(tmp_path))
    kwargs = dict(duration=DURATION, batch_size=1, sample_rate=16000,
                  max_polyphony=N_SYNTHS)
    got = list(pipeline.get_test_dataset(root, **kwargs))
    want = list(jpipe.get_test_dataset(root, **kwargs))
    assert len(got) == len(want) >= 8
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
