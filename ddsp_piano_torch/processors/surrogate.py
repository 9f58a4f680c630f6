"""Surrogate additive synthesizer: partials with exponential decay
envelopes whose time base restarts at each onset.

Counterpart of ddsp_piano_tpu/processors/surrogate.py:27-190. The JAX
package renders the decay oscillator in plain jnp, with no Pallas kernel,
so the port renders it in plain torch too: the framewise closed form of
ops/oscillator.py (phase cumsum in float64) times the envelope
|d|^(up T[k] + s), over (b, frames, up, K) intermediates in chunks of
frames.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ddsp_piano_torch.ops import core, oscillator
from ddsp_piano_torch.processors.base import Processor


def render_framewise_decay(controls: oscillator.FramewiseOscControls,
                           decays: torch.Tensor, decay_time: torch.Tensor,
                           upsampling: int, sample_rate: int
                           ) -> torch.Tensor:
    """Framewise render with per-partial decay: (b, n_frames, K) controls,
    decays (b, n_frames, K), decay_time (b, n_frames, 1) in frames ->
    (b, n_frames * up). env[k, s] = |decays[k]| ** (up decay_time[k] + s),
    as exp(log|d| t) (surrogate.py:76-117). Chunking over frames changes no
    value."""
    decays = core.f32(decays)
    decay_time = core.f32(decay_time)
    up = upsampling
    f_lo, f_hi, a_lo, a_hi, phase0 = controls
    b, n_frames, k = f_lo.shape
    w_scale = 2.0 * math.pi / float(sample_rate)
    nyquist = sample_rate / 2.0
    s = torch.arange(up, dtype=torch.float32, device=f_lo.device)
    s_col = s[None, None, :, None]
    h = (torch.sin((math.pi / (2.0 * up)) * s) ** 2)[None, None, :, None]
    tri = (s_col * (s_col + 1.0)) * (0.5 / up)
    chunk = max(1, oscillator._MAX_CHUNK_ELEMENTS // max(b * up * k, 1))
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


def surrogate_harmonic_synthesis(frequencies, amplitudes, decays,
                                 decay_time, harmonic_shifts,
                                 harmonic_distribution, upsampling=64,
                                 sample_rate=16000) -> torch.Tensor:
    """Oscillator bank with decaying partials (surrogate.py:27-73), all
    frame rate: frequencies (b, t, 1), amplitudes (b, t, 1), decays
    (b, t, K), decay_time (b, t, 1), harmonic_shifts and
    harmonic_distribution (b, t, K). (The JAX function's optional
    controls, which the surrogate synth always passes, are required.)"""
    freqs, amps = SurrogateAdditive.fold_controls(
        amplitudes, harmonic_distribution, harmonic_shifts, frequencies)
    controls = oscillator.framewise_osc_controls(freqs, amps, upsampling,
                                                 sample_rate)
    return render_framewise_decay(controls, decays, decay_time, upsampling,
                                  sample_rate)


class SurrogateAdditive(Processor):
    """The surrogate inharmonic synth (surrogate.py:120-190): scaled
    amplitudes and harmonic distribution, stiff-string partials, decays
    clipped to [1e-5, 1] and set to 1 at or above Nyquist."""

    def __init__(self, frame_rate: int = 250, sample_rate: int = 16000,
                 min_frequency: float = 20.0,
                 normalize_harm_distribution: bool = True,
                 scale_fn: Optional[Callable] = core.exp_sigmoid,
                 normalize_below_nyquist: bool = True,
                 name: str = 'inharmonic'):
        super().__init__(name=name)
        self.frame_rate = frame_rate
        self.sample_rate = sample_rate
        self.min_frequency = min_frequency
        self.normalize_harm_distribution = normalize_harm_distribution
        self.scale_fn = scale_fn
        self.normalize_below_nyquist = normalize_below_nyquist

    @property
    def upsampling(self) -> int:
        return int(self.sample_rate / self.frame_rate)

    def get_controls(self, amplitudes, decays, decay_time,
                     harmonic_distribution, inharm_coef, f0_hz):
        if self.scale_fn is not None:
            amplitudes = self.scale_fn(amplitudes)
            harmonic_distribution = self.scale_fn(harmonic_distribution)
        amplitudes = core.f32(amplitudes)
        harmonic_distribution = core.f32(harmonic_distribution)
        inharm_coef = core.maximum(core.f32(inharm_coef), 0.0)
        n_harmonics = harmonic_distribution.shape[-1]
        inharmonic_freq, harmonic_shifts = core.get_inharmonic_freq(
            f0_hz, inharm_coef, n_harmonics)
        decays = core.clip(core.f32(decays), 1e-5, 1.0)
        decays = torch.where(inharmonic_freq >= self.sample_rate / 2.0,
                             torch.ones_like(decays), decays)
        if self.normalize_below_nyquist:
            harmonic_distribution = core.remove_above_nyquist(
                inharmonic_freq, harmonic_distribution, self.sample_rate)
            amplitudes = amplitudes * (core.f32(f0_hz) > self.min_frequency
                                       ).to(torch.float32)
        if self.normalize_harm_distribution:
            harmonic_distribution = core.safe_divide(
                harmonic_distribution,
                torch.sum(harmonic_distribution, dim=-1, keepdim=True))
        return {'amplitudes': amplitudes,
                'decays': decays,
                'decay_time': core.f32(decay_time),
                'harmonic_distribution': harmonic_distribution,
                'harmonic_shifts': harmonic_shifts,
                'f0_hz': core.f32(f0_hz)}

    @staticmethod
    def fold_controls(amplitudes, harmonic_distribution, harmonic_shifts,
                      f0_hz):
        """Per-partial (frequencies, amplitudes) at frame rate, each
        (b, t, K): the one-shot render's and the streaming driver's shared
        representation (surrogate.py:168-175; one substring, no fold)."""
        freqs = core.get_harmonic_frequencies(
            core.f32(f0_hz), harmonic_distribution.shape[-1])
        return (freqs * (1.0 + harmonic_shifts),
                core.f32(amplitudes) * harmonic_distribution)

    def get_signal(self, amplitudes, decays, decay_time,
                   harmonic_distribution, harmonic_shifts, f0_hz):
        return surrogate_harmonic_synthesis(
            frequencies=f0_hz, amplitudes=amplitudes, decays=decays,
            decay_time=decay_time, harmonic_shifts=harmonic_shifts,
            harmonic_distribution=harmonic_distribution,
            upsampling=self.upsampling, sample_rate=self.sample_rate)
