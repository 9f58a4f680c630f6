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


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16 (ties to even), as float32. Its
    gradient is the incoming gradient rounded the same way, as JAX
    transposes a convert to bfloat16 and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def midi_to_hz(notes) -> torch.Tensor:
    """MIDI note number to frequency in Hz (A4 = 69 = 440 Hz)."""
    notes = f32(notes)
    # A float32 division by a Python scalar is a multiplication by its
    # reciprocal on the GPU, a true division on the CPU: divide in float64.
    octaves = rounded(torch.div, notes - 69.0, 12.0)
    return 440.0 * rounded(lambda x: torch.pow(2.0, x), octaves)


def hz_to_midi(frequencies) -> torch.Tensor:
    """Frequency in Hz to (fractional) MIDI note number; 0 Hz and below map
    to 0 (core.py:42-46)."""
    frequencies = f32(frequencies)
    notes = 12.0 * (torch.log2(frequencies) - math.log2(440.0)) + 69.0
    return torch.where(frequencies <= 0.0, torch.zeros_like(notes), notes)


def unit_to_midi(unit, midi_min=20.0, midi_max=90.0, clip=False):
    """[0, 1] -> [midi_min, midi_max] (core.py:49-51)."""
    unit = f32(unit)
    unit = torch.clamp(unit, 0.0, 1.0) if clip else unit
    return midi_min + (midi_max - midi_min) * unit


def midi_to_unit(midi, midi_min=20.0, midi_max=90.0, clip=False):
    """[midi_min, midi_max] -> [0, 1] (core.py:54-56)."""
    unit = (f32(midi) - midi_min) / (midi_max - midi_min)
    return torch.clamp(unit, 0.0, 1.0) if clip else unit


def exp_sigmoid(x, exponent=10.0, max_value=2.0, threshold=1e-7):
    """``max_value * sigmoid(x) ** log(exponent) + threshold``."""
    x = f32(x)
    return max_value * torch.sigmoid(x) ** math.log(exponent) + threshold


def positive_tanh(x) -> torch.Tensor:
    """(tanh(x) + 1) / 2, in (0, 1)."""
    return 0.5 * (torch.tanh(f32(x)) + 1.0)


def exp_tanh(x, max_value=2.0, exponent=10.0, gain=1.0, threshold=1e-7):
    """exp_sigmoid on tanh, which saturates faster: ``max_value *
    positive_tanh(gain x) ** log(exponent) + threshold`` (core.py:72-78,
    the ENSTDkCl, multi-instrument and surrogate synths' scaling)."""
    y = max_value * positive_tanh(gain * f32(x)) ** math.log(exponent)
    return y + threshold


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


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi), with its
    gradient at the bounds (half, as :func:`maximum`)."""
    return torch.minimum(maximum(x, lo), x.new_full((), hi))


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


def get_harmonic_frequencies(frequencies, n_harmonics: int
                             ) -> torch.Tensor:
    """(..., 1) fundamentals -> (..., n_harmonics) multiples, by the JAX
    package's float32 harmonic numbers (core.py:101-114)."""
    frequencies = f32(frequencies)
    return frequencies * harmonic_numbers(n_harmonics, frequencies.device)


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


def nearest_resample(x, n_timesteps: int) -> torch.Tensor:
    """Nearest-neighbour resampling along axis 1 (legacy TF v1 convention,
    core.py:192-198)."""
    x = f32(x)
    n_in = x.shape[1]
    src = torch.arange(n_timesteps, dtype=torch.float32,
                       device=x.device) * (n_in / n_timesteps)
    idx = torch.clamp(torch.floor(src).long(), 0, n_in - 1)
    return torch.index_select(x, 1, idx)


def upsample_with_windows(inputs, n_timesteps: int,
                          add_endpoint: bool = True) -> torch.Tensor:
    """Upsample (batch, n_frames, ch) by half-overlapping Hann windows, as
    the raised-cosine crossfade of core.py:214-250:
    out[k hop + s] = a[k] (1 - h[s]) + a[k+1] h[s], h[s] = sin^2(pi s /
    (2 hop)). The window is evaluated in float64 and rounded once."""
    if inputs.dim() != 3:
        raise ValueError("upsample_with_windows expects (batch, time, ch), "
                         f"got shape {tuple(inputs.shape)}")
    inputs = f32(inputs)
    if add_endpoint:
        inputs = torch.cat([inputs, inputs[:, -1:, :]], dim=1)
    n_frames = inputs.shape[1]
    n_intervals = n_frames - 1
    if n_frames >= n_timesteps:
        raise ValueError(f"upsample_with_windows can only upsample: "
                         f"{n_frames} frames -> {n_timesteps} timesteps.")
    if n_timesteps % n_intervals != 0:
        raise ValueError(f"n_timesteps ({n_timesteps}) must be divisible by "
                         f"n_intervals ({n_intervals}).")
    hop = n_timesteps // n_intervals
    s = torch.arange(hop, dtype=torch.float64, device=inputs.device)
    h = (torch.sin(math.pi * s / (2.0 * hop)) ** 2).float()
    h = h[None, None, :, None]
    left = inputs[:, :-1, None, :]
    right = inputs[:, 1:, None, :]
    out = left * (1.0 - h) + right * h          # (b, n_intervals, hop, ch)
    return out.reshape(out.shape[0], n_timesteps, out.shape[-1])


def resample(inputs, n_timesteps: int, method: str = 'linear',
             add_endpoint: bool = True) -> torch.Tensor:
    """Resample along the time axis (axis 1) of a 1-D to 4-D input:
    'nearest', 'linear' (legacy coordinates) or 'window' (overlapping Hann),
    as core.py:253-277."""
    inputs = f32(inputs)
    if inputs.dim() == 4:
        b, t, c1, c2 = inputs.shape
        out = resample(inputs.reshape(b, t, c1 * c2), n_timesteps,
                       method=method, add_endpoint=add_endpoint)
        return out.reshape(b, n_timesteps, c1, c2)
    x, rank = _ensure_3d(inputs)
    if method == 'nearest':
        out = nearest_resample(x, n_timesteps)
    elif method == 'linear':
        out = linear_resample(x, n_timesteps, align_corners=not add_endpoint)
    elif method == 'window':
        out = upsample_with_windows(x, n_timesteps, add_endpoint=add_endpoint)
    else:
        raise ValueError(f"Unknown resample method: {method!r} "
                         "(expected 'nearest', 'linear' or 'window').")
    return _restore_rank(out, rank)


def angular_cumsum(angular_frequency, chunk_size: int = 1000
                   ) -> torch.Tensor:
    """Cumulative sum over axis 1 (time) with a mod-2pi accumulation per
    chunk of ``chunk_size`` steps, then the chunks' offsets, as
    core.py:285-307: in float32 like the JAX function, or in float64 for a
    float64 input (the envelope oscillator's phase)."""
    x = angular_frequency
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float64):
        x = f32(x)
    length = x.shape[1]
    n_chunks = -(-length // chunk_size)
    pad = n_chunks * chunk_size - length
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))],
                      dim=1)
    chunked = x.reshape((x.shape[0], n_chunks, chunk_size)
                        + tuple(x.shape[2:]))
    phase = _mod(torch.cumsum(chunked, dim=2), _2PI)
    last = phase[:, :, -1]
    offsets = _mod(torch.cumsum(last, dim=1) - last, _2PI)
    phase = _mod(phase + offsets[:, :, None], _2PI)
    phase = phase.reshape((x.shape[0], n_chunks * chunk_size)
                          + tuple(x.shape[2:]))
    return phase[:, :length]


def _mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """jnp.mod: the remainder with the sign of the divisor."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def pad_or_trim_to_expected_length(vector, expected_len: int,
                                   pad_value: float = 0.0,
                                   len_tolerance: int = 20):
    """Crop or right-pad the last axis to ``expected_len``; a gap larger
    than ``len_tolerance`` raises (core.py:310-326)."""
    expected_len = int(expected_len)
    vector_len = int(vector.shape[-1])
    if abs(vector_len - expected_len) > len_tolerance:
        raise ValueError(
            f"Vector length {vector_len} differs from expected "
            f"{expected_len} by more than tolerance {len_tolerance}.")
    if vector_len > expected_len:
        return vector[..., :expected_len]
    if vector_len < expected_len:
        vector = torch.as_tensor(vector)
        return torch.nn.functional.pad(vector, (0, expected_len - vector_len),
                                       value=pad_value)
    return vector


def make_iterable(x):
    """A single object as a one-element tuple; None as (); lists and
    tuples as tuples (core.py:329-335)."""
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def cross_fade(a: torch.Tensor, b: torch.Tensor, n=None) -> torch.Tensor:
    """Equal-power crossfade of the last n samples of ``a`` into the first
    n of ``b`` (core.py:338-349); the fade curves are float32 like JAX's."""
    if n is None:
        n = min(a.shape[-1], b.shape[-1])
    if n == 0:
        return torch.cat([a, b], dim=-1)
    t = torch.from_numpy(linspace_f32(0.0, 1.0, n)).to(a.device)
    fade_out = torch.cos(t * (math.pi / 2.0))
    fade_in = torch.sin(t * (math.pi / 2.0))
    overlap = a[..., -n:] * fade_out + b[..., :n] * fade_in
    return torch.cat([a[..., :-n], overlap, b[..., n:]], dim=-1)
