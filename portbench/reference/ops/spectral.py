"""Spectral ops: framing, STFT magnitudes and the multi-scale spectral
distance.

Counterpart of ddsp_piano_tpu/ops/spectral.py. Framing follows
tf.signal.frame with pad_end (n_frames = ceil(n / hop), the tail
zero-padded) and the window is TF's periodic Hann; torch.stft, which
centres its frames, is not used. Magnitudes come from the rfft; the
distances are L1, L2 and COSINE (:155-172); the multi-scale loss has the
terms of :210-257 but the loudness's, which neither configuration weighs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from portbench.reference.ops import core


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


def compute_mag(audio: torch.Tensor, size: int = 2048, overlap: float = 0.75,
                pad_end: bool = True) -> torch.Tensor:
    """|STFT| by the rfft (the JAX package's default)."""
    return torch.abs(stft(audio, frame_size=size, overlap=overlap,
                          pad_end=pad_end)).float()


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
        weights: Optional[torch.Tensor] = None,
        per_element: bool = False) -> torch.Tensor:
    """Multi-resolution STFT distance: per FFT size, the magnitudes', their
    time and frequency deltas', their cumulative sum over frequency's and
    the log magnitudes' mean differences; with
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
    return loss
