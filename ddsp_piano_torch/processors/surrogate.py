"""Surrogate additive synthesizer: partials with exponential decay
envelopes whose time base restarts at each onset.

Counterpart of ddsp_piano_tpu/processors/surrogate.py:27-190. The JAX
package renders the decay oscillator in plain jnp, with no Pallas kernel.
The port renders it through kernels/oscillator_decay.py: the framewise
closed form of ops/oscillator.py (phase cumsum in float64) times the
envelope |d|^(up T[k] + s), as the kernel K10 on the card (K11 its
gradients) and as ops.oscillator.render_framewise_decay, its plain
version, on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ddsp_piano_torch import tracing
from ddsp_piano_torch.kernels.oscillator_decay import \
    render_framewise_decay_skip
from ddsp_piano_torch.ops import core, oscillator
# The plain render, importable from here as before it moved to ops.
from ddsp_piano_torch.ops.oscillator import render_framewise_decay  # noqa
from ddsp_piano_torch.processors.base import Processor


def render_decay(controls: oscillator.FramewiseOscControls,
                 decays: torch.Tensor, decay_time: torch.Tensor,
                 upsampling: int, sample_rate: int) -> torch.Tensor:
    """The decay render through its front door (K10, with K11 for its
    gradients, on the card), in the span ``synth.surrogate``: (b,
    n_frames, K) controls, decays (b, n_frames, K), decay_time (b,
    n_frames, 1) -> (b, n_frames * up)."""
    with tracing.span('synth.surrogate'):
        return render_framewise_decay_skip(controls, decays, decay_time,
                                           upsampling, sample_rate)


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
    return render_decay(controls, decays, decay_time, upsampling,
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
