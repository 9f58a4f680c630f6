"""Core signal ops: the subset of ddsp_piano_tpu/ops/core.py the v2 render
and its training loss call (core.py:31-136, 201-211). Resampling is not on
that path and is not ported.
"""

from __future__ import annotations

import math

import torch

_2PI = 2.0 * math.pi


def f32(x) -> torch.Tensor:
    """Float32 tensor (a tensor keeps its device)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32)
    return torch.as_tensor(x, dtype=torch.float32)


def rounded(fn, *args) -> torch.Tensor:
    """``fn`` of float32 tensors, evaluated in float64 and rounded once to
    float32: the correctly rounded result, the same on every device.

    Used on the frequency path. There a 1-ulp difference in a partial's
    frequency grows into a phase error 2 pi df t, which shows in the
    rendered audio, and the float32 transcendentals of the CPU and of the
    GPU differ in the last place.
    """
    return fn(*(a.double() if isinstance(a, torch.Tensor) else a
                for a in args)).float()


def midi_to_hz(notes) -> torch.Tensor:
    """MIDI note number to frequency in Hz (A4 = 69 = 440 Hz)."""
    notes = f32(notes)
    # A float32 division by a Python scalar is a multiplication by its
    # reciprocal on the GPU, a true division on the CPU: divide in float64.
    octaves = rounded(torch.div, notes - 69.0, 12.0)
    return 440.0 * rounded(lambda x: torch.pow(2.0, x), octaves)


def exp_sigmoid(x, exponent=10.0, max_value=2.0, threshold=1e-7):
    """``max_value * sigmoid(x) ** log(exponent) + threshold``."""
    x = f32(x)
    return max_value * torch.sigmoid(x) ** math.log(exponent) + threshold


def safe_divide(numerator, denominator, eps=1e-7):
    """Division that replaces a zero denominator by eps."""
    safe = torch.where(denominator == 0.0,
                       torch.full_like(denominator, eps), denominator)
    return numerator / safe


def safe_log(x, eps=1e-5) -> torch.Tensor:
    """log(x) with x <= eps replaced by eps: the gradient is zero there
    (a ``where``, not a clamp, as core.py:87-89)."""
    return torch.log(torch.where(x <= eps, torch.full_like(x, eps), x))


def hann_window(window_length: int, periodic: bool = True,
                device=None) -> torch.Tensor:
    """tf.signal.hann_window: the raised-cosine denominator is
    L + periodic * (1 - L % 2) - 1 (core.py:201-211). Evaluated in float64
    and rounded once, so every device gets the same window."""
    if window_length == 1:
        return torch.ones((1,), dtype=torch.float32, device=device)
    denom = window_length + (1 - window_length % 2 if periodic else 0) - 1
    n = torch.arange(window_length, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(_2PI * n / denom)).float()


def remove_above_nyquist(frequency_envelopes, amplitude_envelopes,
                         sample_rate=16000):
    """Zero amplitudes of oscillators at or above the Nyquist frequency."""
    mask = (f32(frequency_envelopes) < sample_rate / 2.0).to(torch.float32)
    return f32(amplitude_envelopes) * mask


def harmonic_numbers(n_harmonics: int, device) -> torch.Tensor:
    """1, 2, ..., n as float32 (jnp.linspace(1, n, n))."""
    return torch.linspace(1.0, float(n_harmonics), n_harmonics,
                          dtype=torch.float32, device=device)


def get_inharmonic_freq(f0_hz, inharm_coef, n_harmonics: int):
    """Stiff-string partials f_k = f0 * k * sqrt(1 + B k^2).

    Returns ((b, t, n_harmonics) frequencies in Hz,
             (b, t, n_harmonics) shifts sqrt(1 + B k^2) - 1).
    """
    f0_hz = f32(f0_hz)
    k = harmonic_numbers(n_harmonics, f0_hz.device)
    inharm_factor = rounded(torch.sqrt, k * k * f32(inharm_coef) + 1.0)
    return f0_hz * k * inharm_factor, inharm_factor - 1.0
