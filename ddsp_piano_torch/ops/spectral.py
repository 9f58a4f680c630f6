"""Spectral ops: framing, STFT magnitudes, loudness, mel and the
multi-scale spectral distance.

Counterpart of ddsp_piano_tpu/ops/spectral.py. Framing follows
tf.signal.frame with pad_end (n_frames = ceil(n / hop), the tail
zero-padded) and the window is TF's periodic Hann; torch.stft, which
centres its frames, is not used. Magnitudes come from the rfft ('fft') or
from the windowed DFT as two matmuls ('mm', :75-112); the distances are
L1, L2 and COSINE (:155-172); the loudness is the A-weighted power in dB
(:175-207); the multi-scale loss has every term of :210-257; compute_mel
multiplies the magnitudes by the mel filterbank (:260-293). The host
constants (the DFT basis, the mel matrix) are float64 numpy rounded to
float32, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ddsp_piano_torch.ops import core


def frame(x: torch.Tensor, frame_length: int, frame_step: int,
          pad_end: bool = False) -> torch.Tensor:
    """(..., samples) -> (..., n_frames, frame_length), as tf.signal.frame:
    with pad_end, n_frames = ceil(len / step) and the tail is zero-padded;
    without, n_frames = 1 + (len - length) // step."""
    n = x.shape[-1]
    if pad_end:
        n_frames = -(-n // frame_step)
        full_len = (n_frames - 1) * frame_step + frame_length
        if full_len > n:
            x = torch.nn.functional.pad(x, (0, full_len - n))
    else:
        n_frames = 1 + (n - frame_length) // frame_step
    return x.unfold(-1, frame_length, frame_step)[..., :n_frames, :]


def stft(audio: torch.Tensor, frame_size: int = 2048, overlap: float = 0.75,
         pad_end: bool = True) -> torch.Tensor:
    """Complex (..., n_frames, frame_size // 2 + 1) STFT with a periodic
    Hann window and hop frame_size * (1 - overlap)."""
    hop = int(frame_size * (1.0 - overlap))
    audio = core.f32(audio)
    frames = frame(audio, frame_size, hop, pad_end=pad_end)
    window = core.hann_window(frame_size, periodic=True, device=audio.device)
    return torch.fft.rfft(frames * window, n=frame_size, dim=-1)


@functools.lru_cache(maxsize=16)
def _dft_mag_basis(frame_size: int):
    """(frame_size, frame_size // 2 + 1) cosine and sine DFT bases with
    the periodic Hann window folded in, float64 rounded to float32
    (spectral.py:75-92)."""
    n = np.arange(frame_size, dtype=np.float64)
    k = np.arange(frame_size // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / frame_size
    denom = frame_size + (1 - frame_size % 2) - 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)
    return ((np.cos(ang) * w[:, None]).astype(np.float32),
            (np.sin(ang) * w[:, None]).astype(np.float32))


def _compute_mag_mm(audio: torch.Tensor, size: int, overlap: float,
                    pad_end: bool) -> torch.Tensor:
    """|STFT| as two basis matmuls and a hypot with a 1e-24 floor (a finite
    gradient at zero magnitude), spectral.py:95-112 at 'highest'."""
    hop = int(size * (1.0 - overlap))
    frames = frame(core.f32(audio), size, hop, pad_end=pad_end)
    cos_b, sin_b = (torch.from_numpy(b).to(frames.device)
                    for b in _dft_mag_basis(size))
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    return torch.sqrt(re * re + im * im + 1e-24)


def compute_mag(audio: torch.Tensor, size: int = 2048, overlap: float = 0.75,
                pad_end: bool = True, method: str = 'fft') -> torch.Tensor:
    """|STFT|: 'fft' (the rfft; the JAX package's default) or 'mm' (the
    windowed DFT by matmul). The JAX package's 'auto' reads an
    environment knob and means 'fft' unless it is set."""
    if method == 'auto':
        method = 'fft'
    if method == 'mm':
        return _compute_mag_mm(audio, size, overlap, pad_end)
    if method != 'fft':
        raise ValueError(
            f"compute_mag method={method!r}: expected 'auto', 'fft' or 'mm'")
    return torch.abs(stft(audio, frame_size=size, overlap=overlap,
                          pad_end=pad_end)).float()


def compute_logmag(audio: torch.Tensor, size: int = 2048,
                   **kwargs) -> torch.Tensor:
    return core.safe_log(compute_mag(audio, size=size, **kwargs))


def _mean(x: torch.Tensor, per_element: bool) -> torch.Tensor:
    if per_element:
        return torch.mean(x, dim=tuple(range(1, x.dim())))
    return torch.mean(x)


def mean_difference(target: torch.Tensor, value: torch.Tensor,
                    loss_type: str = 'L1',
                    weights: Optional[torch.Tensor] = None,
                    per_element: bool = False) -> torch.Tensor:
    """Mean of a difference metric, over everything or, with
    ``per_element``, over all axes but the first: 'L1' (the absolute
    difference, with JAX's gradient +1 at a tie), 'L2' (the squared
    difference) or 'COSINE' (1 - cosine similarity of each batch
    element's flattened values, then the mean)."""
    difference = target - value
    weights = 1.0 if weights is None else weights
    loss_type = loss_type.upper()
    if loss_type == 'L1':
        return _mean(core.abs_(difference * weights), per_element)
    if loss_type == 'L2':
        return _mean(difference ** 2 * weights, per_element)
    if loss_type == 'COSINE':
        t = target.reshape(target.shape[0], -1)
        v = value.reshape(value.shape[0], -1)
        num = torch.sum(t * v, dim=-1)
        den = torch.linalg.vector_norm(t, dim=-1) * torch.linalg.vector_norm(
            v, dim=-1)
        distance = 1.0 - num / core.maximum(den, 1e-12)
        return distance if per_element else torch.mean(distance)
    raise ValueError(f"Unknown loss_type: {loss_type!r}")


def _a_weighting_db(frequencies_hz: torch.Tensor) -> torch.Tensor:
    """A-weighting in dB (IEC 61672:2003), in float32 as
    spectral.py:175-182."""
    f = torch.clamp(core.f32(frequencies_hz), min=1e-6)
    f2 = f ** 2
    ra = (12194.0 ** 2 * f2 ** 2) / (
        (f2 + 20.6 ** 2)
        * torch.sqrt((f2 + 107.7 ** 2) * (f2 + 737.9 ** 2))
        * (f2 + 12194.0 ** 2))
    return 20.0 * torch.log10(torch.clamp(ra, min=1e-20)) + 2.0


def _rfftfreq(n_fft: int, sample_rate: int, device) -> torch.Tensor:
    """jnp.fft.rfftfreq in float32: k * (1 / (n d)) with d = 1 / sr."""
    val = np.float32(1.0 / (n_fft * np.float32(1.0 / sample_rate)))
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float32, device=device)
    return k * float(val)


def compute_loudness(audio: torch.Tensor, sample_rate: int = 16000,
                     frame_rate: int = 250, n_fft: int = 2048,
                     range_db: float = 120.0,
                     ref_db: float = 0.0) -> torch.Tensor:
    """Perceptual loudness in dB at the frame rate: the STFT power,
    A-weighted per bin, averaged over bins, in dB minus ``ref_db`` and
    floored at -range_db (spectral.py:185-207)."""
    audio = core.f32(audio)
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None, :]
    hop = sample_rate // frame_rate
    overlap = 1.0 - hop / n_fft
    s = stft(audio, frame_size=n_fft, overlap=overlap, pad_end=True)
    power = torch.abs(s) ** 2
    a_weight = 10.0 ** (_a_weighting_db(
        _rfftfreq(n_fft, sample_rate, audio.device)) / 10.0)
    weighted_power = torch.mean(power * a_weight, dim=-1)
    loudness = 10.0 * torch.log10(core.maximum(weighted_power, 1e-20)) \
        - ref_db
    loudness = core.maximum(loudness, -range_db)
    return loudness[0] if squeeze else loudness


def multi_scale_spectral_loss(
        target_audio: torch.Tensor,
        audio: torch.Tensor,
        fft_sizes: Sequence[int] = (2048, 1024, 512, 256, 128, 64),
        loss_type: str = 'L1',
        mag_weight: float = 1.0,
        logmag_weight: float = 0.0,
        delta_time_weight: float = 0.0,
        delta_freq_weight: float = 0.0,
        cumsum_freq_weight: float = 0.0,
        loudness_weight: float = 0.0,
        sample_rate: int = 16000,
        weights: Optional[torch.Tensor] = None,
        per_element: bool = False) -> torch.Tensor:
    """Multi-resolution STFT distance: per FFT size, the magnitudes', their
    time and frequency deltas', their cumulative sum over frequency's and
    the log magnitudes' mean differences, then the loudness's; with
    ``per_element`` one distance per batch element, shape (batch,)."""
    loss = 0.0
    diff_t = lambda m: m[:, 1:] - m[:, :-1]
    diff_f = lambda m: m[..., 1:] - m[..., :-1]

    def dist(t, v):
        return mean_difference(t, v, loss_type, weights, per_element)

    for size in fft_sizes:
        target_mag = compute_mag(target_audio, size=size)
        value_mag = compute_mag(audio, size=size)
        if mag_weight > 0:
            loss += mag_weight * dist(target_mag, value_mag)
        if delta_time_weight > 0:
            loss += delta_time_weight * dist(diff_t(target_mag),
                                             diff_t(value_mag))
        if delta_freq_weight > 0:
            loss += delta_freq_weight * dist(diff_f(target_mag),
                                             diff_f(value_mag))
        if cumsum_freq_weight > 0:
            loss += cumsum_freq_weight * dist(
                torch.cumsum(target_mag, dim=-1),
                torch.cumsum(value_mag, dim=-1))
        if logmag_weight > 0:
            loss += logmag_weight * dist(core.safe_log(target_mag),
                                         core.safe_log(value_mag))
    if loudness_weight > 0:
        loss += loudness_weight * dist(
            compute_loudness(target_audio, sample_rate=sample_rate),
            compute_loudness(audio, sample_rate=sample_rate))
    return loss


def compute_mel(audio: torch.Tensor, sample_rate: int = 16000,
                lo_hz: float = 0.0, hi_hz: float = 8000.0, bins: int = 64,
                fft_size: int = 2048, overlap: float = 0.75,
                pad_end: bool = True) -> torch.Tensor:
    """Mel-scaled magnitude spectrogram (spectral.py:260-269)."""
    mag = compute_mag(audio, size=fft_size, overlap=overlap, pad_end=pad_end)
    mel_matrix = _linear_to_mel_matrix(bins, mag.shape[-1], sample_rate,
                                       lo_hz, hi_hz)
    return torch.matmul(mag, torch.from_numpy(mel_matrix).to(mag.device))


@functools.lru_cache(maxsize=8)
def _linear_to_mel_matrix(num_mel_bins, num_spectrogram_bins, sample_rate,
                          lower_edge_hertz, upper_edge_hertz) -> np.ndarray:
    """Triangular mel filters on a linear frequency grid, float64 rounded
    to float32 (spectral.py:272-293)."""
    def hz_to_mel(f):
        return 1127.0 * np.log1p(f / 700.0)

    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0, nyquist, num_spectrogram_bins)
    mel_edges = np.linspace(hz_to_mel(lower_edge_hertz),
                            hz_to_mel(upper_edge_hertz), num_mel_bins + 2)
    mel_freqs = hz_to_mel(linear_freqs)
    lower, center, upper = mel_edges[:-2], mel_edges[1:-1], mel_edges[2:]
    up_slope = (mel_freqs[:, None] - lower[None, :]) / np.maximum(
        center - lower, 1e-8)[None, :]
    down_slope = (upper[None, :] - mel_freqs[:, None]) / np.maximum(
        upper - center, 1e-8)[None, :]
    weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    return weights.astype(np.float32)
