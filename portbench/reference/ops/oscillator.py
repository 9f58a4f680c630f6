"""Framewise closed-form additive oscillator (plain PyTorch).

Counterpart of ddsp_piano_tpu/ops/oscillator.py:121-262. The audio-rate
render of each frame is a closed form of frame-rate controls:

  phase(k, s) = P[k] + w * ((s+1) f_lo[k] + df[k] s(s+1) / (2 up))
  P[k] = sum_{k'<k} w * (up f_lo[k'] + df[k'] (up-1)/2)   (mod 2pi)

so the only serial work is a frame-rate cumsum. ``render_framewise`` is
the plain version of the oscillator kernel (kernels/oscillator.py): the
kernel computes the same terms and skips partials that are exactly zero.
``render_framewise_vjp`` is the plain version of the backward kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from portbench.reference.ops import core

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
