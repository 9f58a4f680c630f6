"""Core signal ops: the counterpart of ddsp_piano_tpu/ops/core.py
(core.py:31-136, 162-349): conversions, scalings, resampling, the chunked
phase cumsum and the length and cross-fade helpers.
"""

from __future__ import annotations

import functools
import math

import numpy as np
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


def abs_(x: torch.Tensor) -> torch.Tensor:
    """jnp.abs(x), with its gradient: +1 at 0 (torch.abs gives 0 there).
    The L1 regularisers meet it: the inharmonicity modifiers start at 0."""
    return torch.where(x >= 0, x, -x)


def maximum(x: torch.Tensor, value: float) -> torch.Tensor:
    """jnp.maximum(x, value), with its gradient: half the cotangent to x
    where x equals the bound (torch.clamp passes all of it). The bound is
    filled on x's device (new_tensor would copy it from the host, which
    synchronises the stream)."""
    return torch.maximum(x, x.new_full((), value))


def safe_divide(numerator, denominator, eps=1e-7):
    """Division that replaces a zero denominator by eps."""
    safe = torch.where(denominator == 0.0,
                       torch.full_like(denominator, eps), denominator)
    return numerator / safe


def safe_log(x, eps=1e-5) -> torch.Tensor:
    """log(x) with x <= eps replaced by eps: the gradient is zero there
    (a ``where``, not a clamp, as core.py:87-89)."""
    return torch.log(torch.where(x <= eps, torch.full_like(x, eps), x))


def hann_window(window_length: int, periodic: bool = True, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """tf.signal.hann_window: the raised-cosine denominator is
    L + periodic * (1 - L % 2) - 1 (core.py:201-211). Evaluated in float64
    and rounded once to ``dtype``, so every device gets the same window."""
    if window_length == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    denom = window_length + (1 - window_length % 2 if periodic else 0) - 1
    n = torch.arange(window_length, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(_2PI * n / denom)).to(dtype)


def remove_above_nyquist(frequency_envelopes, amplitude_envelopes,
                         sample_rate=16000):
    """Zero amplitudes of oscillators at or above the Nyquist frequency."""
    mask = (f32(frequency_envelopes) < sample_rate / 2.0).to(torch.float32)
    return f32(amplitude_envelopes) * mask


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """The JAX package's float32 ``jnp.linspace(start, stop, num)``, value
    for value: ``a = start (1 - i c)`` and ``fma(i, stop c, a)`` with
    ``c = 1 / (num - 1)`` rounded to float32, the last point ``stop`` (the
    program XLA compiles for jnp.linspace on the CPU). It is not exact on
    integers: linspace(1, 96, 96) puts 3 at 3.0000002. num >= 2."""
    f32_ = np.float32
    i = np.arange(num - 1, dtype=f32_)
    c = f32_(1.0 / (num - 1))
    a = f32_(start) * (f32_(1.0) - i * c)
    out = (i.astype(np.float64) * np.float64(f32_(stop) * c)
           + a.astype(np.float64)).astype(f32_)
    return np.append(out, f32_(stop))


@functools.lru_cache(maxsize=None)
def _harmonic_numbers_on(n_harmonics: int, device: torch.device):
    with torch.inference_mode(False):
        return torch.from_numpy(
            linspace_f32(1.0, float(n_harmonics), n_harmonics)).to(device)


def harmonic_numbers(n_harmonics: int, device) -> torch.Tensor:
    """The harmonic numbers 1, ..., n as the JAX package makes them
    (jnp.linspace(1, n, n), see linspace_f32): an ulp off the integer
    for some k at n = 96 or 192. A harmonic number one ulp away moves
    partial k by ~6e-8 of its frequency, which grows into a phase error
    2 pi df t. Copied to ``device`` once, outside inference mode (as
    ops.filters' constants)."""
    return _harmonic_numbers_on(n_harmonics, torch.device(device))


def get_inharmonic_freq(f0_hz, inharm_coef, n_harmonics: int):
    """Stiff-string partials f_k = f0 * k * sqrt(1 + B k^2).

    Returns ((b, t, n_harmonics) frequencies in Hz,
             (b, t, n_harmonics) shifts sqrt(1 + B k^2) - 1).
    """
    f0_hz = f32(f0_hz)
    k = harmonic_numbers(n_harmonics, f0_hz.device)
    inharm_factor = rounded(torch.sqrt, k * k * f32(inharm_coef) + 1.0)
    return f0_hz * k * inharm_factor, inharm_factor - 1.0


# -- resampling ----------------------------------------------------------------


def _ensure_3d(x: torch.Tensor):
    """1-D/2-D inputs as (batch, time, channels), and the original rank."""
    rank = x.dim()
    if rank == 1:
        x = x[None, :, None]
    elif rank == 2:
        x = x[:, :, None]
    return x, rank


def _restore_rank(x: torch.Tensor, rank: int) -> torch.Tensor:
    if rank == 1:
        return x[0, :, 0]
    if rank == 2:
        return x[:, :, 0]
    return x


def linear_resample(x, n_timesteps: int, align_corners: bool = False
                    ) -> torch.Tensor:
    """Linear resampling along axis 1 of a (batch, time, ...) tensor, in the
    legacy ``tf.compat.v1.image.resize_bilinear`` coordinates (core.py:
    162-189): output index j reads source position ``j * n_in / n_out``, or
    ``j * (n_in - 1) / (n_out - 1)`` with align_corners. Not
    F.interpolate, whose coordinates are half-pixel centred: the legacy ones
    are what the released checkpoints were trained with."""
    x = f32(x)
    n_in = x.shape[1]
    if n_in == n_timesteps:
        return x
    if align_corners and n_timesteps > 1:
        scale = (n_in - 1) / (n_timesteps - 1)
    else:
        scale = n_in / n_timesteps
    src = torch.arange(n_timesteps, dtype=torch.float32,
                       device=x.device) * scale
    lo = torch.clamp(torch.floor(src).long(), 0, n_in - 1)
    hi = torch.clamp(lo + 1, 0, n_in - 1)
    frac = (src - lo.to(torch.float32)).reshape(
        [1, n_timesteps] + [1] * (x.dim() - 2))
    x_lo = torch.index_select(x, 1, lo)
    x_hi = torch.index_select(x, 1, hi)
    return x_lo + (x_hi - x_lo) * frac


def resample(inputs, n_timesteps: int, method: str = 'linear',
             add_endpoint: bool = True) -> torch.Tensor:
    """Resample along the time axis (axis 1) of a 1-D to 4-D input by
    'linear' (legacy coordinates), as core.py:253-277; its 'nearest' and
    'window' methods are not in the reference."""
    inputs = f32(inputs)
    if inputs.dim() == 4:
        b, t, c1, c2 = inputs.shape
        out = resample(inputs.reshape(b, t, c1 * c2), n_timesteps,
                       method=method, add_endpoint=add_endpoint)
        return out.reshape(b, n_timesteps, c1, c2)
    x, rank = _ensure_3d(inputs)
    if method != 'linear':
        raise ValueError(f"Unknown resample method: {method!r} "
                         "(expected 'linear').")
    out = linear_resample(x, n_timesteps, align_corners=not add_endpoint)
    return _restore_rank(out, rank)
