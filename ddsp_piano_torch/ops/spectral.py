"""Spectral ops of the training loss: framing, STFT magnitudes and the
multi-scale spectral distance.

Counterpart of ddsp_piano_tpu/ops/spectral.py:26-257 (the 'fft' magnitude
path). Framing follows tf.signal.frame with pad_end (n_frames =
ceil(n / hop), the tail zero-padded) and the window is TF's periodic Hann;
torch.stft, which centres its frames, is not used. The loudness, mel,
delta and windowed-DFT-matmul ('mm') branches are not ported: the v2 loss
does not call them.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


def compute_mag(audio: torch.Tensor, size: int = 2048, overlap: float = 0.75,
                pad_end: bool = True) -> torch.Tensor:
    """|STFT| (the JAX package's 'fft' method)."""
    return torch.abs(stft(audio, frame_size=size, overlap=overlap,
                          pad_end=pad_end)).float()


def compute_logmag(audio: torch.Tensor, size: int = 2048,
                   **kwargs) -> torch.Tensor:
    return core.safe_log(compute_mag(audio, size=size, **kwargs))


def mean_difference(target: torch.Tensor, value: torch.Tensor,
                    loss_type: str = 'L1',
                    weights: Optional[torch.Tensor] = None,
                    per_element: bool = False) -> torch.Tensor:
    """Mean absolute difference (the JAX package's 'L1'; its 'L2' and
    'COSINE' are not used by the ported losses and are refused), over
    everything, or with ``per_element`` over all axes but the first."""
    if loss_type.upper() != 'L1':
        raise NotImplementedError(f"loss_type {loss_type!r} is not ported "
                                  "to ddsp_piano_torch yet; it has 'L1'")
    difference = target - value
    weights = 1.0 if weights is None else weights
    # JAX's abs: gradient +1 at a tie (torch.abs gives 0).
    distance = core.abs_(difference * weights)
    if per_element:
        return torch.mean(distance, dim=tuple(range(1, distance.dim())))
    return torch.mean(distance)


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
    """Multi-resolution STFT distance: per FFT size, the magnitudes' and
    the log magnitudes' mean difference; with ``per_element`` one distance
    per batch element, shape (batch,). The delta, cumulative-frequency
    and loudness terms of the JAX package are refused: no ported loss sets
    them."""
    del sample_rate
    unported = {'delta_time_weight': delta_time_weight,
                'delta_freq_weight': delta_freq_weight,
                'cumsum_freq_weight': cumsum_freq_weight,
                'loudness_weight': loudness_weight}
    unported = [k for k, v in unported.items() if v > 0]
    if unported:
        raise NotImplementedError(f"{unported} of the spectral loss are not "
                                  "ported to ddsp_piano_torch yet")
    loss = 0.0
    for size in fft_sizes:
        target_mag = compute_mag(target_audio, size=size)
        value_mag = compute_mag(audio, size=size)
        if mag_weight > 0:
            loss += mag_weight * mean_difference(
                target_mag, value_mag, loss_type, weights, per_element)
        if logmag_weight > 0:
            loss += logmag_weight * mean_difference(
                core.safe_log(target_mag), core.safe_log(value_mag),
                loss_type, weights, per_element)
    return loss
