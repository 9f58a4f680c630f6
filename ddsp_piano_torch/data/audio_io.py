"""Audio reading and writing, resampling and dBFS normalisation (numpy,
scipy and the stdlib wave module; other formats through ffmpeg).

Copies of read_wav, resample_audio, decode_audio_ffmpeg,
load_audio_as_signal, write_wav, dbfs and normalize_audio from
ddsp_piano_tpu/data/audio_io.py. Wav files are read here; anything else
(mp3, flac, ogg, ...) is decoded by an ``ffmpeg`` subprocess, which must be
on PATH.
"""

from __future__ import annotations

import wave
from fractions import Fraction

import numpy as np


def read_wav(path: str):
    """Read a 16/24/32-bit PCM wav -> (float32 (n_samples, channels), rate)."""
    with wave.open(path, 'rb') as w:
        rate = w.getframerate()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, '<i2').astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, '<i4').astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        ints = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported wav sample width {width}")
    return data.reshape(-1, channels), rate


def resample_audio(audio: np.ndarray, orig_rate: int,
                   target_rate: int) -> np.ndarray:
    """Polyphase resampling along axis 0."""
    if orig_rate == target_rate:
        return audio
    from scipy.signal import resample_poly
    frac = Fraction(target_rate, orig_rate).limit_denominator(1000)
    return resample_poly(audio, frac.numerator, frac.denominator,
                         axis=0).astype(np.float32)


def decode_audio_ffmpeg(path: str, sample_rate: int) -> np.ndarray:
    """Decode any ffmpeg-readable file (mp3/flac/ogg/...) to mono float32
    in [-1, 1] at ``sample_rate``: one ``ffmpeg`` subprocess streaming raw
    f32le samples, ffmpeg doing the resample (the reference decodes through
    pydub, which shells out to ffmpeg: ddsp_piano utils/io_utils.py:50-74).
    Raises RuntimeError with no ``ffmpeg`` on PATH, on a non-zero exit and
    on zero decoded samples."""
    import shutil
    import subprocess

    ffmpeg = shutil.which('ffmpeg')
    if ffmpeg is None:
        raise RuntimeError(
            f"Cannot decode {path!r}: not a wav file and no `ffmpeg` binary "
            f"on PATH. Install ffmpeg for mp3/flac/ogg inputs, or convert "
            f"to wav. (MAESTRO ships wav; this path only serves "
            f"user-supplied audio.)")
    proc = subprocess.run(
        [ffmpeg, '-v', 'error', '-i', path, '-f', 'f32le', '-ac', '1',
         '-ar', str(int(sample_rate)), 'pipe:1'],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if proc.returncode != 0:
        raise RuntimeError(
            f"ffmpeg failed to decode {path!r}: "
            f"{proc.stderr.decode(errors='replace').strip()}")
    samples = np.frombuffer(proc.stdout, '<f4').astype(np.float32)
    if samples.size == 0:
        raise RuntimeError(
            f"ffmpeg decoded zero samples from {path!r} (corrupt or empty "
            f"stream): {proc.stderr.decode(errors='replace').strip()}")
    # Lossy codecs decode slightly outside [-1, 1]; clip to the range that
    # load_audio_as_signal promises.
    return np.clip(samples, -1.0, 1.0)


def _is_wav(path: str) -> bool:
    """RIFF/WAVE header sniff (whatever the extension); False on a file
    that cannot be read."""
    try:
        with open(path, 'rb') as f:
            head = f.read(12)
        return head[:4] == b'RIFF' and head[8:12] == b'WAVE'
    except OSError:
        return False


def load_audio_as_signal(audio_path: str,
                         sample_rate: int = 16000) -> np.ndarray:
    """Load audio as mono float32 at the target sample rate. A wav file is
    read here, at length int(duration * sample_rate) (padded or trimmed
    after resampling); anything else goes to decode_audio_ffmpeg."""
    if not _is_wav(audio_path):
        return decode_audio_ffmpeg(audio_path, sample_rate)
    data, rate = read_wav(audio_path)
    mono = data.mean(axis=1)
    expected_len = int(len(mono) / rate * sample_rate)
    audio = resample_audio(mono, rate, sample_rate)
    if len(audio) > expected_len:
        audio = audio[:expected_len]
    elif len(audio) < expected_len:
        audio = np.pad(audio, (0, expected_len - len(audio)))
    return audio.astype(np.float32)


def write_wav(path: str, audio: np.ndarray, sample_rate: int,
              clip: bool = True):
    """Write mono/stereo float audio to a 16-bit wav."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[:, np.newaxis]
    if clip:
        audio = np.clip(audio, -1.0, 1.0)
    pcm = (audio * 32767.0).astype('<i2')
    with wave.open(path, 'wb') as w:
        w.setnchannels(audio.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())


def dbfs(audio: np.ndarray) -> float:
    """RMS level relative to full scale, in dB (pydub convention)."""
    rms = float(np.sqrt(np.mean(np.square(audio), dtype=np.float64)))
    if rms <= 0:
        return -float('inf')
    return 20.0 * np.log10(rms)


def normalize_audio(audio_file: str, volume: float = -20.0):
    """Rewrite a wav file gain-adjusted to the target dBFS level."""
    data, rate = read_wav(audio_file)
    gain_db = volume - dbfs(data)
    write_wav(audio_file, data * (10.0 ** (gain_db / 20.0)), rate)
