"""Framewise closed-form additive oscillator (plain PyTorch).

Counterpart of ddsp_piano_tpu/ops/oscillator.py:121-262. The audio-rate
render of each frame is a closed form of frame-rate controls:

  phase(k, s) = P[k] + w * ((s+1) f_lo[k] + df[k] s(s+1) / (2 up))
  P[k] = sum_{k'<k} w * (up f_lo[k'] + df[k'] (up-1)/2)   (mod 2pi)

so the only serial work is a frame-rate cumsum. ``render_framewise`` is
the plain version of the oscillator kernel (kernels/oscillator.py): the
kernel computes the same terms and skips partials that are exactly zero.
``render_framewise_vjp`` is the plain version of the backward kernel.
``render_framewise_decay`` and ``render_framewise_decay_vjp`` are the
same pair for the surrogate synth's decaying partials
(kernels/oscillator_decay.py).

Also the envelope pipeline (``oscillator_bank_envelopes``, :57-86) and the
``harmonic_synthesis`` front door (:506-595) of the single-f0 InHarmonic
synth; its framewise path goes through the skipping oscillator's front
door, and its phase sums are float64 like the framewise controls'.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ddsp_piano_torch.ops import core

_2PI = 2.0 * math.pi

# Cody-Waite range reduction + degree-6 cosine polynomial: the TPU kernels'
# default trig (ddsp_piano_tpu/kernels/oscillator_pallas.py:71-115).
_INV_2PI = 0.15915494309189535
_2PI_HI = 6.28125
_2PI_LO = 0.0019353071795864769
_COS6 = (9.999999875e-01, -1.973920397e+01, 6.493908942e+01,
         -8.544960659e+01, 6.016310858e+01, -2.595008830e+01,
         6.503441062e+00)
# Degree-4 sin/cos for gradients only (oscillator_pallas.py:80-87): the
# TPU backward kernel's default when the forward runs 'poly'.
_COS4 = (9.999681959e-01, -1.973229255e+01, 6.470140570e+01,
         -8.259851900e+01, 4.606319347e+01)
_SIN4 = (6.283166561e+00, -4.133763108e+01, 8.146544324e+01,
         -7.503236765e+01, 3.381005338e+01)

TRIGS = ('native', 'poly')
GRAD_TRIGS = ('native', 'poly4')
# Elements of one chunk's (b, frames, up, K) intermediate in the plain
# render.
_MAX_CHUNK_ELEMENTS = 1 << 24


class FramewiseOscControls(NamedTuple):
    """Frame-rate controls; each field (batch, n_frames, n_partials) f32."""
    f_lo: torch.Tensor     # frequency at frame start (Hz)
    f_hi: torch.Tensor     # frequency at next frame (clamped at the end)
    a_lo: torch.Tensor     # amplitude at frame start
    a_hi: torch.Tensor     # amplitude at next frame (clamped at the end)
    phase0: torch.Tensor   # accumulated phase at frame start, mod 2pi


def mod_2pi(x: torch.Tensor) -> torch.Tensor:
    """jnp.mod(x, 2pi): an exact fmod, shifted into [0, 2pi)."""
    r = torch.fmod(x, _2PI)
    return torch.where(r < 0, r + _2PI, r)


def phase_increments(f: torch.Tensor, f_hi: torch.Tensor, upsampling: int,
                      sample_rate: int) -> torch.Tensor:
    """Each frame's phase advance, mod 2pi, computed in float32 and widened
    to float64: w (up f_lo + (f_hi - f_lo) (up - 1) / 2)."""
    up = float(upsampling)
    w_scale = _2PI / float(sample_rate)
    inc = w_scale * (up * f + (f_hi - f) * ((up - 1.0) / 2.0))
    return mod_2pi(inc).double()


def framewise_osc_controls(harmonic_frequencies: torch.Tensor,
                           harmonic_amplitudes: torch.Tensor,
                           upsampling: int,
                           sample_rate: int,
                           initial_phase: Optional[torch.Tensor] = None,
                           lookahead: bool = False) -> FramewiseOscControls:
    """Frame-rate oscillator controls from (b, n_frames, K) partial
    frequencies (Hz) and amplitudes. The phase cumsum is a plain
    torch.cumsum (the JAX package's _blocked_cumsum is a TPU schedule),
    taken in float64.

    Streaming (ops/oscillator.py:133-172): ``initial_phase`` (b, 1, K),
    the phase carried from the previous chunk, is added before the one
    rounding to float32 (pass it in float64, as
    :func:`framewise_final_phase` returns it); with ``lookahead`` the last
    frame is only the interpolation endpoint, so n_frames - 1 frames
    render."""
    f = core.f32(harmonic_frequencies)
    a = core.f32(harmonic_amplitudes)
    if lookahead:
        f, f_hi = f[:, :-1], f[:, 1:]
        a, a_hi = a[:, :-1], a[:, 1:]
    else:
        f_hi = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
        a_hi = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    inc = phase_increments(f, f_hi, upsampling, sample_rate)
    # The frame-rate phase accumulates in float64: exact to rounding
    # whatever order the device sums in. A float32 sum reaches n_frames *
    # 2pi, where one ulp is already ~1e-4 rad at 250 frames.
    phase = torch.cumsum(inc, dim=1) - inc
    if initial_phase is not None:
        phase = phase + initial_phase.double()
    return FramewiseOscControls(f, f_hi, a, a_hi, mod_2pi(phase).float())


def framewise_final_phase(controls: FramewiseOscControls, upsampling: int,
                          sample_rate: int,
                          initial_phase: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The phase after the last frame, (b, 1, K) float64 mod 2pi: the
    phase the next chunk starts from (ops/oscillator.py:175-188).
    ``initial_phase`` is the one the controls were made with. It is the
    float64 sum of every frame's advance, so a streamed render carries its
    phase as exactly as the one-shot cumsum and rounds once a chunk."""
    inc = phase_increments(controls.f_lo, controls.f_hi, upsampling,
                            sample_rate)
    total = torch.sum(inc, dim=1, keepdim=True)
    if initial_phase is not None:
        total = total + initial_phase.double()
    return mod_2pi(total)


def sample_tables(upsampling: int, device) -> Tuple[torch.Tensor, ...]:
    """Per-sample constants of the closed form, each (up,) float32:
    h = sin^2(pi s / (2 up)), tri = s(s+1)/(2 up), s + 1 and s / up."""
    up = upsampling
    s = torch.arange(up, dtype=torch.float32, device=device)
    h = torch.sin((math.pi / (2.0 * up)) * s) ** 2
    tri = (s * (s + 1.0)) * (0.5 / up)
    return h, tri, s + 1.0, s * (1.0 / up)


def _range_reduce(phi: torch.Tensor) -> torch.Tensor:
    """phi / 2pi mod 1, in ~[-0.5, 0.5]: Cody-Waite with a two-part 2pi."""
    n = torch.round(phi * _INV_2PI)
    xr = phi - n * _2PI_HI
    xr = xr - n * _2PI_LO
    return xr * _INV_2PI


def _poly(coeffs, t: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def _cos(phi: torch.Tensor, trig: str) -> torch.Tensor:
    if trig == 'native':
        return torch.cos(phi)
    x = _range_reduce(phi)
    return _poly(_COS6, x * x)


def _sincos(phi: torch.Tensor, trig: str):
    """(sin, cos) for gradients: 'native' or 'poly4' (oscillator_pallas.py
    _sincos, :118-140)."""
    if trig == 'native':
        return torch.sin(phi), torch.cos(phi)
    x = _range_reduce(phi)
    t = x * x
    return x * _poly(_SIN4, t), _poly(_COS4, t)


def gradient_tables(upsampling: int, sample_rate: int, device):
    """The per-sample weights of the backward's five sums, each (up,)
    float32: 1 - h (a_lo), h (a_hi), w ((s + 1) - tri) (f_lo) and w tri
    (f_hi), with w = 2 pi / sample_rate (oscillator_pallas.py:449-454)."""
    h, tri, s1, _ = sample_tables(upsampling, device)
    w_scale = _2PI / float(sample_rate)
    return 1.0 - h, h, w_scale * (s1 - tri), w_scale * tri


def render_framewise(controls: FramewiseOscControls, upsampling: int,
                     sample_rate: int, trig: str = 'native') -> torch.Tensor:
    """Plain render: (b, n_frames, K) controls -> (b, n_frames * up).

    Computes every partial (dead ones included), in chunks of frames so
    the (b, frames, up, K) intermediate stays bounded; chunking does not
    change any value. ``trig`` mirrors the TPU kernels' _cos: 'native'
    (torch.cos) or 'poly' (the kernels' range reduction + polynomial).
    """
    if trig not in TRIGS:
        raise ValueError(f"trig={trig!r}: expected one of {TRIGS}")
    f_lo, f_hi, a_lo, a_hi, phase0 = controls
    b, n_frames, k = f_lo.shape
    up = upsampling
    w_scale = _2PI / float(sample_rate)
    nyquist = sample_rate / 2.0
    h, tri, s1, s_frac = (v[None, None, :, None]
                          for v in sample_tables(up, f_lo.device))
    one_minus_h = 1.0 - h
    chunk = max(1, _MAX_CHUNK_ELEMENTS // max(b * up * k, 1))
    parts = []
    for start in range(0, n_frames, chunk):
        sl = slice(start, start + chunk)
        flo = f_lo[:, sl, None, :]
        df = (f_hi[:, sl] - f_lo[:, sl])[:, :, None, :]
        phase = phase0[:, sl, None, :] + w_scale * (s1 * flo + df * tri)
        amp = a_lo[:, sl, None, :] * one_minus_h + a_hi[:, sl, None, :] * h
        freq = flo + df * s_frac
        amp = amp * (freq < nyquist).to(torch.float32)
        parts.append(torch.sum(amp * _cos(phase, trig), dim=-1))
    return torch.cat(parts, dim=1).reshape(b, n_frames * up)


def render_framewise_vjp(controls: FramewiseOscControls, g: torch.Tensor,
                         upsampling: int, sample_rate: int,
                         trig: str = 'poly4') -> FramewiseOscControls:
    """Plain VJP of render_framewise: the five control gradients from the
    audio cotangent g (b, n_frames * up), as the five weighted sums over
    each frame's samples of oscillator_pallas.py:430-454, with
    gc = g mask cos and gs = -g amp sin. Chunked over frames like
    render_framewise. ``trig``: 'poly4' (the TPU backward kernel's
    default) or 'native'."""
    if trig not in GRAD_TRIGS:
        raise ValueError(f"trig={trig!r}: expected one of {GRAD_TRIGS}")
    f_lo, f_hi, a_lo, a_hi, phase0 = controls
    b, n_frames, k = f_lo.shape
    up = upsampling
    w_scale = _2PI / float(sample_rate)
    nyquist = sample_rate / 2.0
    h, tri, s1, s_frac = (v[None, None, :, None]
                          for v in sample_tables(up, f_lo.device))
    w_alo, w_ahi, w_flo, w_fhi = (
        v[None, None, :, None]
        for v in gradient_tables(up, sample_rate, f_lo.device))
    g = g.reshape(b, n_frames, up)
    chunk = max(1, _MAX_CHUNK_ELEMENTS // max(b * up * k, 1))
    parts = [[] for _ in range(5)]
    for start in range(0, n_frames, chunk):
        sl = slice(start, start + chunk)
        flo = f_lo[:, sl, None, :]
        df = (f_hi[:, sl] - f_lo[:, sl])[:, :, None, :]
        phase = phase0[:, sl, None, :] + w_scale * (s1 * flo + df * tri)
        mask = (flo + df * s_frac) < nyquist
        amp = torch.where(mask, a_lo[:, sl, None, :] * w_alo
                          + a_hi[:, sl, None, :] * h, 0.0)
        sin_p, cos_p = _sincos(phase, trig)
        gg = g[:, sl, :, None]
        gc = gg * torch.where(mask, cos_p, 0.0)
        gs = gg * amp * (-sin_p)
        for out, value in zip(parts, (gs * w_flo, gs * w_fhi, gc * w_alo,
                                      gc * w_ahi, gs)):
            out.append(torch.sum(value, dim=2))
    return FramewiseOscControls(*(torch.cat(p, dim=1) for p in parts))


def render_framewise_decay(controls: FramewiseOscControls,
                           decays: torch.Tensor, decay_time: torch.Tensor,
                           upsampling: int, sample_rate: int
                           ) -> torch.Tensor:
    """Plain render with per-partial decay (the surrogate synth's, and the
    plain version of its kernel, kernels/oscillator_decay.py): (b,
    n_frames, K) controls, decays (b, n_frames, K), decay_time (b,
    n_frames, 1) in frames -> (b, n_frames * up). Each term of
    render_framewise times env[k, s] = |decays[k]| ** (up decay_time + s),
    as exp(log|d| t) (ddsp_piano_tpu/processors/surrogate.py:76-117), with
    torch.cos. Chunking over frames changes no value."""
    decays = core.f32(decays)
    decay_time = core.f32(decay_time)
    up = upsampling
    f_lo, f_hi, a_lo, a_hi, phase0 = controls
    b, n_frames, k = f_lo.shape
    w_scale = _2PI / float(sample_rate)
    nyquist = sample_rate / 2.0
    s = torch.arange(up, dtype=torch.float32, device=f_lo.device)
    s_col = s[None, None, :, None]
    h = (torch.sin((math.pi / (2.0 * up)) * s) ** 2)[None, None, :, None]
    tri = (s_col * (s_col + 1.0)) * (0.5 / up)
    chunk = max(1, _MAX_CHUNK_ELEMENTS // max(b * up * k, 1))
    parts = []
    for start in range(0, n_frames, chunk):
        sl = slice(start, start + chunk)
        log_d = torch.log(torch.abs(decays[:, sl]))[:, :, None, :]
        t_base = (decay_time[:, sl] * up)[:, :, None, :]
        decay_env = torch.exp(log_d * (t_base + s_col))
        flo = f_lo[:, sl, None, :]
        df = (f_hi[:, sl] - f_lo[:, sl])[:, :, None, :]
        amp = a_lo[:, sl, None, :] * (1.0 - h) + a_hi[:, sl, None, :] * h
        freq = flo + df * (s_col * (1.0 / up))
        amp = amp * (freq < nyquist).to(torch.float32)
        amp = amp * decay_env
        phase = phase0[:, sl, None, :] + w_scale * (
            (s_col + 1.0) * flo + df * tri)
        parts.append(torch.sum(amp * torch.cos(phase), dim=-1))
    return torch.cat(parts, dim=1).reshape(b, n_frames * up)


class DecayGrads(NamedTuple):
    """The gradients of render_framewise_decay's inputs."""
    controls: FramewiseOscControls
    decays: torch.Tensor       # (b, n_frames, K)
    decay_time: torch.Tensor   # (b, n_frames, 1)


def render_framewise_decay_vjp(controls: FramewiseOscControls,
                               decays: torch.Tensor,
                               decay_time: torch.Tensor, g: torch.Tensor,
                               upsampling: int, sample_rate: int
                               ) -> DecayGrads:
    """Plain VJP of render_framewise_decay (the plain version of its
    backward kernel) from the audio cotangent g (b, n_frames * up), with
    torch.sin and torch.cos. Per sample, with the envelope e = exp(log|d|
    t), t = up decay_time + s, and ge = g e:
    gc = ge mask cos, gs = -ge amp sin, q = gc amp; then the sums over the
    frame's samples d a_lo = sum gc (1 - h), d a_hi = sum gc h, d phase0 =
    sum gs, d f_lo = sum gs w ((s + 1) - tri), d f_hi = sum gs w tri,
    d decays = sum q t / d, and d decay_time = up sum_k log|d| sum_s q.
    Chunked over frames like the forward."""
    decays = core.f32(decays)
    decay_time = core.f32(decay_time)
    f_lo, f_hi, a_lo, a_hi, phase0 = controls
    b, n_frames, k = f_lo.shape
    up = upsampling
    w_scale = _2PI / float(sample_rate)
    nyquist = sample_rate / 2.0
    h, tri, s1, s_frac = (v[None, None, :, None]
                          for v in sample_tables(up, f_lo.device))
    w_alo, w_ahi, w_flo, w_fhi = (
        v[None, None, :, None]
        for v in gradient_tables(up, sample_rate, f_lo.device))
    s_col = s1 - 1.0
    g = g.reshape(b, n_frames, up)
    chunk = max(1, _MAX_CHUNK_ELEMENTS // max(b * up * k, 1))
    parts = [[] for _ in range(7)]
    for start in range(0, n_frames, chunk):
        sl = slice(start, start + chunk)
        log_d = torch.log(torch.abs(decays[:, sl]))[:, :, None, :]
        t = (decay_time[:, sl] * up)[:, :, None, :] + s_col
        env = torch.exp(log_d * t)
        flo = f_lo[:, sl, None, :]
        df = (f_hi[:, sl] - f_lo[:, sl])[:, :, None, :]
        phase = phase0[:, sl, None, :] + w_scale * (s1 * flo + df * tri)
        mask = (flo + df * s_frac) < nyquist
        amp = torch.where(mask, a_lo[:, sl, None, :] * w_alo
                          + a_hi[:, sl, None, :] * h, 0.0)
        ge = g[:, sl, :, None] * env
        gc = torch.where(mask, ge * torch.cos(phase), 0.0)
        gs = ge * amp * (-torch.sin(phase))
        q = gc * amp
        for out, value in zip(parts, (gs * w_flo, gs * w_fhi, gc * w_alo,
                                      gc * w_ahi, gs, q * t, q)):
            out.append(torch.sum(value, dim=2))
    sums = [torch.cat(p, dim=1) for p in parts]
    log_d = torch.log(torch.abs(decays))
    return DecayGrads(
        FramewiseOscControls(*sums[:5]), sums[5] / decays,
        torch.sum(log_d * sums[6], dim=-1, keepdim=True) * float(up))


def oscillator_bank_envelopes(frequency_envelopes, amplitude_envelopes,
                              sample_rate: int = 16000,
                              sum_sinusoids: bool = True,
                              use_angular_cumsum: bool = False,
                              initial_phase: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Cosine oscillator bank from (b, n_samples, K) sample-rate envelopes
    (ops/oscillator.py:57-86): Nyquist mask, Hz -> rad/sample, cumulative
    phase, cos. The phase sums in float64 (the JAX package sums in
    float32, whose ulp is 2.4e-4 rad at one second of a 440 Hz partial at
    16 kHz); ``use_angular_cumsum``
    takes the chunked mod-2pi sum of :func:`core.angular_cumsum` in
    float64 too. Returns (b, n_samples), or (b, n_samples, K) without
    ``sum_sinusoids``."""
    frequency_envelopes = core.f32(frequency_envelopes)
    amplitude_envelopes = core.remove_above_nyquist(
        frequency_envelopes, amplitude_envelopes, sample_rate)
    omegas = frequency_envelopes * (_2PI / float(sample_rate))
    if use_angular_cumsum:
        phases = core.angular_cumsum(omegas.double())
    else:
        phases = torch.cumsum(omegas.double(), dim=1)
    if initial_phase is not None:
        phases = phases + initial_phase.double()
    audio = amplitude_envelopes * torch.cos(phases).float()
    if sum_sinusoids:
        audio = torch.sum(audio, dim=-1)
    return audio


def harmonic_synthesis(frequencies, amplitudes,
                       harmonic_shifts: Optional[torch.Tensor] = None,
                       harmonic_distribution: Optional[torch.Tensor] = None,
                       n_samples: int = 64000, sample_rate: int = 16000,
                       amp_resample_method: str = 'window',
                       sum_sinusoids: bool = True,
                       use_angular_cumsum: bool = False,
                       method: str = 'framewise',
                       initial_phase: Optional[torch.Tensor] = None,
                       return_final_phase: bool = False,
                       lookahead: bool = False):
    """Frame-rate harmonic controls -> audio (ops/oscillator.py:506-595).

    frequencies and amplitudes (b, n_frames, 1); harmonic_shifts and
    harmonic_distribution (b, n_frames, K). ``method='framewise'`` (when
    n_samples is a whole number of frames, window amplitudes and summed
    sinusoids) renders through the skipping oscillator's front door (K1 on
    the card); otherwise, or with ``method='envelopes'``, the envelopes
    are resampled to the audio rate and summed by
    :func:`oscillator_bank_envelopes`. ``initial_phase`` (b, 1, K) and
    ``return_final_phase`` carry the phase for streaming; the returned
    phase is float64, mod 2pi."""
    from ddsp_piano_torch.kernels.oscillator import render_framewise_skip

    frequencies = core.f32(frequencies)
    amplitudes = core.f32(amplitudes)
    if harmonic_distribution is not None:
        harmonic_distribution = core.f32(harmonic_distribution)
        n_harmonics = harmonic_distribution.shape[-1]
    elif harmonic_shifts is not None:
        n_harmonics = harmonic_shifts.shape[-1]
    else:
        n_harmonics = 1
    harmonic_frequencies = core.get_harmonic_frequencies(frequencies,
                                                         n_harmonics)
    if harmonic_shifts is not None:
        harmonic_frequencies = harmonic_frequencies * (1.0 + harmonic_shifts)
    harmonic_amplitudes = (amplitudes * harmonic_distribution
                           if harmonic_distribution is not None
                           else amplitudes)

    n_frames = frequencies.shape[1] - (1 if lookahead else 0)
    framewise_ok = (method == 'framewise' and n_frames > 0
                    and n_samples % n_frames == 0
                    and n_samples // n_frames >= 1
                    and amp_resample_method == 'window' and sum_sinusoids)
    if lookahead and not framewise_ok:
        raise ValueError("lookahead streaming requires the framewise path "
                         "(n_samples divisible by n_frames - 1, window amps)")
    if framewise_ok:
        up = n_samples // n_frames
        controls = framewise_osc_controls(
            harmonic_frequencies, harmonic_amplitudes, up, sample_rate,
            initial_phase=initial_phase, lookahead=lookahead)
        audio = render_framewise_skip(controls, up, sample_rate)
        if return_final_phase:
            return audio, framewise_final_phase(controls, up, sample_rate,
                                                initial_phase=initial_phase)
        return audio

    frequency_envelopes = core.resample(harmonic_frequencies, n_samples)
    amplitude_envelopes = core.resample(harmonic_amplitudes, n_samples,
                                        method=amp_resample_method)
    audio = oscillator_bank_envelopes(
        frequency_envelopes, amplitude_envelopes, sample_rate=sample_rate,
        sum_sinusoids=sum_sinusoids, use_angular_cumsum=use_angular_cumsum,
        initial_phase=initial_phase)
    if return_final_phase:
        omegas = frequency_envelopes.double() * (_2PI / float(sample_rate))
        final = torch.sum(omegas, dim=1, keepdim=True)
        if initial_phase is not None:
            final = final + initial_phase.double()
        return audio, mod_2pi(final)
    return audio
