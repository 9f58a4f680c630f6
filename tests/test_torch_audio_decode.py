"""The port's non-wav audio decoding through ffmpeg, on the CPU.

The four cases of tests/test_audio_decode.py against
ddsp_piano_torch.data.audio_io, with the same stub ``ffmpeg`` (a
PATH-visible script that decodes a raw-f32le fixture and resamples it
linearly to ``-ar``): a wav never touches ffmpeg, no ffmpeg raises
clearly, the decode resamples, and the raw-folder pipeline loads an mp3
track. Also the port's decode against the JAX package's on the same
fixture, bit for bit, and JAX's other two errors (a non-zero exit, zero
samples) raised the same way.
"""

import csv
import os
import stat
import sys

import numpy as np
import pytest
import threadpoolctl

torch = pytest.importorskip('torch')
torch.set_num_threads(1)
# numpy's BLAS too, for the whole worker (xdist collects every file):
# threaded OpenBLAS stalls at each call's barrier on a loaded host.
threadpoolctl.threadpool_limits(1)

from ddsp_piano_torch.data import audio_io  # noqa: E402
from ddsp_piano_tpu.data import audio_io as jax_audio_io  # noqa: E402
from test_audio_decode import _write_mp3_fixture, stub_ffmpeg  # noqa: E402,F401


def test_wav_path_never_touches_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv('PATH', str(tmp_path / 'nothing-here'))
    wav = str(tmp_path / 'a.wav')
    sine = 0.3 * np.sin(np.linspace(0, 220 * 2 * np.pi, 16000))
    audio_io.write_wav(wav, sine, 16000)
    out = audio_io.load_audio_as_signal(wav, 16000)
    assert len(out) == 16000
    np.testing.assert_array_equal(
        out, jax_audio_io.load_audio_as_signal(wav, 16000))


def test_non_wav_without_ffmpeg_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setenv('PATH', str(tmp_path / 'nothing-here'))
    mp3 = str(tmp_path / 'a.mp3')
    _write_mp3_fixture(mp3)
    with pytest.raises(RuntimeError, match='no `ffmpeg` binary on PATH'):
        audio_io.load_audio_as_signal(mp3, 16000)
    # A path that cannot be read is not a wav: it goes to ffmpeg too.
    with pytest.raises(RuntimeError, match='ffmpeg'):
        audio_io.load_audio_as_signal(str(tmp_path / 'missing.mp3'), 16000)


def test_ffmpeg_fallback_decodes_and_resamples(tmp_path, stub_ffmpeg):
    mp3 = str(tmp_path / 'a.mp3')
    fixture = _write_mp3_fixture(mp3, duration=1.0, freq=220.0)
    out = audio_io.load_audio_as_signal(mp3, 16000)
    assert out.dtype == np.float32
    assert len(out) == 16000
    # Same 220 Hz sine after the stub's resample.
    t = np.arange(16000) / 16000.0
    ref = 0.5 * np.sin(2 * np.pi * 220.0 * t)
    corr = np.corrcoef(out, ref)[0, 1]
    assert corr > 0.99, corr
    assert np.abs(out).max() == pytest.approx(np.abs(fixture).max(),
                                              rel=0.05)


def test_decode_matches_jax_bit_for_bit(tmp_path, stub_ffmpeg):
    mp3 = str(tmp_path / 'a.mp3')
    _write_mp3_fixture(mp3, duration=0.5, freq=440.0)
    for rate in (16000, 24000):
        got = audio_io.decode_audio_ffmpeg(mp3, rate)
        want = jax_audio_io.decode_audio_ffmpeg(mp3, rate)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        assert (audio_io.load_audio_as_signal(mp3, rate).tobytes()
                == want.tobytes())


def _stub(bin_dir, body):
    stub = bin_dir / 'ffmpeg'
    stub.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)


def test_failing_and_empty_decodes_raise_as_jax(tmp_path, monkeypatch):
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    monkeypatch.setenv('PATH', str(bin_dir))
    mp3 = str(tmp_path / 'a.mp3')
    _write_mp3_fixture(mp3, duration=0.1)
    for body, match in (
            ("sys.stderr.write('Invalid data found'); sys.exit(1)",
             'ffmpeg failed to decode .*Invalid data found'),
            ("sys.stderr.write('empty stream')",
             'ffmpeg decoded zero samples .*empty stream')):
        _stub(bin_dir, body)
        for module in (audio_io, jax_audio_io):
            with pytest.raises(RuntimeError, match=match):
                module.load_audio_as_signal(mp3, 16000)


def test_loud_decode_is_clipped(tmp_path, monkeypatch):
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    monkeypatch.setenv('PATH', str(bin_dir))
    _stub(bin_dir, "import numpy as np\nsys.stdout.buffer.write("
          "np.array([1.5, -2.0, 0.25], '<f4').tobytes())")
    out = audio_io.decode_audio_ffmpeg(str(tmp_path / 'a.mp3'), 16000)
    np.testing.assert_array_equal(out, np.float32([1.0, -1.0, 0.25]))


def test_training_pipeline_loads_mp3_tracks(tmp_path, stub_ffmpeg):
    """End to end: a MAESTRO-layout folder whose audio is mp3 feeds the
    port's training pipeline through ffmpeg."""
    from ddsp_piano_torch.data import midi, pipeline

    data_dir = tmp_path / 'maestro'
    data_dir.mkdir()
    _write_mp3_fixture(str(data_dir / 'track.mp3'), duration=4.0)
    midi.write_midi(str(data_dir / 'track.mid'),
                    [midi.Note(60, 80, 0.5, 2.0),
                     midi.Note(64, 70, 1.0, 3.0)])
    with open(data_dir / 'maestro-v3.0.0.csv', 'w', newline='') as f:
        writer = csv.DictWriter(f, ['split', 'year', 'audio_filename',
                                    'midi_filename'])
        writer.writeheader()
        writer.writerow({'split': 'train', 'year': 2018,
                         'audio_filename': 'track.mp3',
                         'midi_filename': 'track.mid'})

    it = pipeline.get_training_dataset(str(data_dir), batch_size=2,
                                       duration=1.0, max_polyphony=4,
                                       sample_rate=16000,
                                       num_parallel_calls=1,
                                       shuffle_buffer_segments=4)
    batch = next(iter(it))
    it.close()
    assert batch['audio'].shape == (2, 16000)
    assert np.isfinite(batch['audio']).all()
    assert float(np.abs(batch['audio']).max()) > 0.1
    assert os.path.exists(data_dir / 'track.mp3')
