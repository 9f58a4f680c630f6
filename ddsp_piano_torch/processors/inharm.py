"""Inharmonic additive synthesizer (v2: one substring, K = 128; dafx22:
two substrings x 96 harmonics, K = 192).

Counterpart of ddsp_piano_tpu/processors/inharm.py:26-174. InHarmonic (one
f0) renders through ops.oscillator.harmonic_synthesis; MultiInharmonic
folds its substrings into one framewise oscillator call. Both reach a
framewise oscillator front door: the skipping oscillator
(kernels.oscillator.render_framewise_skip, K1 on the card) or, for
MultiInharmonic, the all-partials one (render_framewise_full, K8, forward
only).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ddsp_piano_torch.kernels.oscillator import (render_framewise_full,
                                                 render_framewise_skip)
from ddsp_piano_torch.ops import core, oscillator
from ddsp_piano_torch.processors.base import Processor


class InHarmonic(Processor):
    """Scales network outputs into inharmonic-partial controls."""

    def __init__(self, frame_rate: int = 250, sample_rate: int = 16000,
                 min_frequency: float = 20.0,
                 scale_fn: Optional[Callable] = core.exp_sigmoid,
                 normalize_after_nyquist_cut: bool = True,
                 normalize_below_nyquist: bool = True,
                 inference: bool = False, name: str = 'inharmonic'):
        super().__init__(name=name)
        # The JAX synth's chunked mod-2pi cumsum in its envelope fallback.
        self.inference = inference
        self.frame_rate = frame_rate
        self.sample_rate = sample_rate
        self.min_frequency = min_frequency
        self.scale_fn = scale_fn
        self.normalize_after_nyquist_cut = normalize_after_nyquist_cut
        self.normalize_below_nyquist = normalize_below_nyquist

    @property
    def upsampling(self) -> int:
        return int(self.sample_rate / self.frame_rate)

    def get_controls(self, amplitudes, harmonic_distribution, inharm_coef,
                     f0_hz):
        """amplitudes (b, t, 1), harmonic_distribution (b, t, K),
        inharm_coef (b, t, 1), f0_hz (b, t, 1)."""
        inharm_coef = core.maximum(core.f32(inharm_coef), 0.0)
        if self.scale_fn is not None:
            amplitudes = self.scale_fn(amplitudes)
            harmonic_distribution = self.scale_fn(harmonic_distribution)
        amplitudes = core.f32(amplitudes)
        harmonic_distribution = core.f32(harmonic_distribution)
        n_harmonics = harmonic_distribution.shape[-1]
        inharmonic_freq, harmonic_shifts = core.get_inharmonic_freq(
            f0_hz, inharm_coef, n_harmonics)
        if not self.normalize_after_nyquist_cut:
            harmonic_distribution = core.safe_divide(
                harmonic_distribution,
                torch.sum(harmonic_distribution, dim=-1, keepdim=True))
        if self.normalize_below_nyquist:
            harmonic_distribution = core.remove_above_nyquist(
                inharmonic_freq, harmonic_distribution, self.sample_rate)
            amplitudes = amplitudes * (core.f32(f0_hz) > self.min_frequency
                                       ).to(torch.float32)
        if self.normalize_after_nyquist_cut:
            harmonic_distribution = core.safe_divide(
                harmonic_distribution,
                torch.sum(harmonic_distribution, dim=-1, keepdim=True))
        return {'amplitudes': amplitudes,
                'harmonic_distribution': harmonic_distribution,
                'harmonic_shifts': harmonic_shifts,
                'f0_hz': core.f32(f0_hz)}

    def get_signal(self, amplitudes, harmonic_distribution, harmonic_shifts,
                   f0_hz):
        """(b, n_frames * up) audio (inharm.py:101-112)."""
        return oscillator.harmonic_synthesis(
            frequencies=f0_hz, amplitudes=amplitudes,
            harmonic_shifts=harmonic_shifts,
            harmonic_distribution=harmonic_distribution,
            n_samples=self.upsampling * f0_hz.shape[1],
            sample_rate=self.sample_rate,
            use_angular_cumsum=self.inference)


OSCILLATORS = ('skip', 'full')


class MultiInharmonic(InHarmonic):
    """One f0 per substring, (b, t, n_substrings); partial amplitudes and
    shifts are shared and the global amplitude is split evenly. All
    substrings render in one oscillator call.

    ``oscillator`` picks the front door: 'skip' (the default, K1, with
    gradients through K4) or 'full' (K8, every partial, native cosine,
    forward only). It is the port's explicit form of the JAX package's
    render_framewise backend 'pallas_skip' or 'pallas', which
    DDSP_PIANO_TPU_PALLAS selects there."""

    def __init__(self, oscillator: str = 'skip',
                 name: str = 'multi_inharmonic', **kwargs):
        super().__init__(name=name, **kwargs)
        if oscillator not in OSCILLATORS:
            raise ValueError(f"oscillator={oscillator!r}: expected one of "
                             f"{OSCILLATORS}")
        self.oscillator = oscillator

    def get_controls(self, amplitudes, harmonic_distribution, inharm_coef,
                     f0_hz):
        controls = super().get_controls(amplitudes, harmonic_distribution,
                                        inharm_coef, f0_hz[..., 0:1])
        controls['f0_hz'] = core.f32(f0_hz)
        controls['amplitudes'] = controls['amplitudes'] / float(
            f0_hz.shape[-1])
        return controls

    @staticmethod
    def fold_substrings(amplitudes, harmonic_distribution, harmonic_shifts,
                        f0_hz):
        """(freqs, amps), each (b, t, n_harmonics * n_substrings), in the
        HARMONIC-MAJOR order (h1s0, h1s1, h2s0, ...) of inharm.py:136-165:
        the dead (above-Nyquist) partials of all substrings cluster at the
        end, where the oscillator kernel's skip bound cuts them off."""
        b, n_frames, n_sub = f0_hz.shape
        n_harm = harmonic_distribution.shape[-1]
        k = core.harmonic_numbers(n_harm, f0_hz.device)
        shift_mul = 1.0 + harmonic_shifts                       # (b, t, K)
        freqs = (f0_hz[..., None, :] * k[:, None]
                 * shift_mul[..., :, None]
                 ).reshape(b, n_frames, n_harm * n_sub)
        amps = (amplitudes * harmonic_distribution)[..., :, None]
        amps = amps.expand(b, n_frames, n_harm, n_sub).reshape(
            b, n_frames, n_harm * n_sub)
        return freqs, amps

    def render(self, controls: oscillator.FramewiseOscControls
               ) -> torch.Tensor:
        """Framewise controls -> (b, n_frames * up) audio through the
        chosen oscillator's front door."""
        render = (render_framewise_skip if self.oscillator == 'skip'
                  else render_framewise_full)
        return render(controls, self.upsampling, self.sample_rate)

    def get_signal(self, amplitudes, harmonic_distribution, harmonic_shifts,
                   f0_hz):
        freqs, amps = self.fold_substrings(amplitudes, harmonic_distribution,
                                           harmonic_shifts, f0_hz)
        return self.render(oscillator.framewise_osc_controls(
            freqs, amps, self.upsampling, self.sample_rate))
