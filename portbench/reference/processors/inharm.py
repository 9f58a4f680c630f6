"""Inharmonic additive synthesizer (v2: one substring, K = 128; dafx22:
two substrings x 96 harmonics, K = 192).

Counterpart of ddsp_piano_tpu/processors/inharm.py:26-174. InHarmonic
scales the network outputs into the controls of one f0; MultiInharmonic
folds its substrings into one call of the skipping framewise oscillator
(kernels.oscillator.render_framewise_skip, the plain version of K1).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.reference.kernels.oscillator import render_framewise_skip
from portbench.reference.ops import core, oscillator
from portbench.reference.processors.base import Processor


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


class MultiInharmonic(InHarmonic):
    """One f0 per substring, (b, t, n_substrings); partial amplitudes and
    shifts are shared and the global amplitude is split evenly. All
    substrings render in one oscillator call.

    ``oscillator`` is 'skip', the one front door in the reference (K1's
    plain version, with gradients through K4's)."""

    def __init__(self, oscillator: str = 'skip',
                 name: str = 'multi_inharmonic', **kwargs):
        super().__init__(name=name, **kwargs)
        if oscillator != 'skip':
            raise ValueError(f"oscillator={oscillator!r}: the reference "
                             "has only 'skip'")
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
        """Framewise controls -> (b, n_frames * up) audio."""
        return render_framewise_skip(controls, self.upsampling,
                                     self.sample_rate)

    def get_signal(self, amplitudes, harmonic_distribution, harmonic_shifts,
                   f0_hz):
        freqs, amps = self.fold_substrings(amplitudes, harmonic_distribution,
                                           harmonic_shifts, f0_hz)
        return self.render(oscillator.framewise_osc_controls(
            freqs, amps, self.upsampling, self.sample_rate))
