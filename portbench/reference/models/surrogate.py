"""The surrogate model's own parts, in plain float32 PyTorch: its decay
synth, SurrogateModule, DeepDetuner, InharmonicityLoss, and a PianoModel
with the surrogate_module slot.

Counterparts of ddsp_piano_tpu/processors/surrogate.py (:27-190),
models/sub_modules.py (SurrogateModule, DeepDetuner) and models/losses.py
(InharmonicityLoss), written for the benchmark's surrogate cell beside the
frozen copy of maestro_v2's and dafx22's parts, which it reuses. Like the
rest of the reference it imports nothing of ddsp_piano_torch or of the JAX
package, and runs no kernel: the decay render is autograd of its plain
expression. It hands its controls to the skipping oscillator's
CONTROL_HOOKS, so that the benchmark's yardstick counts its terms as it
counts K1's and K4's.

Departures from surrogate.gin (and from the port's initial weights):
- SurrogateModule's decay table is drawn from the seed, 1 - 10^u with u
  uniform in [-5, -3] (a partial's level falling by e in 0.06-6 s at
  16 kHz), not the published ones: a table of ones makes every envelope 1
  (log 1 = 0), which would leave the envelope, its exp and the frames
  since the last onset out of every comparison.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from portbench.reference import nn
from portbench.reference.kernels import oscillator as osc_hooks
from portbench.reference.models.losses import Loss
from portbench.reference.models.piano_model import PianoModel
from portbench.reference.ops import core
from portbench.reference.ops.oscillator import (FramewiseOscControls,
                                                framewise_osc_controls)
from portbench.reference.processors.base import Processor

MIDI_NORM = 128.0
_2PI = 2.0 * math.pi
# Elements of one chunk's (b, frames, up, K) intermediate.
_MAX_CHUNK_ELEMENTS = 1 << 24


def exp_tanh(x, max_value=2.0, exponent=10.0, threshold=1e-7):
    """max_value ((tanh(x) + 1) / 2) ** log(exponent) + threshold
    (core.py:72-78)."""
    y = max_value * (0.5 * (torch.tanh(core.f32(x)) + 1.0)) ** math.log(
        exponent)
    return y + threshold


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: minimum(maximum(x, lo), hi), half the gradient at a
    bound."""
    return torch.minimum(core.maximum(x, lo), x.new_full((), hi))


def render_framewise_decay(controls: FramewiseOscControls,
                           decays: torch.Tensor, decay_time: torch.Tensor,
                           upsampling: int, sample_rate: int
                           ) -> torch.Tensor:
    """(b, n_frames, K) framewise controls, decays (b, n_frames, K) and
    decay_time (b, n_frames, 1) in frames -> (b, n_frames * up): each
    partial's framewise closed form, amplitude crossfaded and masked at
    Nyquist, times |d| ** (up decay_time + s), with torch.cos and torch.exp
    (surrogate.py:76-117). Chunked over frames."""
    for hook in osc_hooks.CONTROL_HOOKS:
        hook(controls, upsampling, sample_rate)
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
        envelope = torch.exp(log_d * (t_base + s_col))
        flo = f_lo[:, sl, None, :]
        df = (f_hi[:, sl] - f_lo[:, sl])[:, :, None, :]
        amp = a_lo[:, sl, None, :] * (1.0 - h) + a_hi[:, sl, None, :] * h
        freq = flo + df * (s_col * (1.0 / up))
        amp = amp * (freq < nyquist).to(torch.float32) * envelope
        phase = phase0[:, sl, None, :] + w_scale * (
            (s_col + 1.0) * flo + df * tri)
        parts.append(torch.sum(amp * torch.cos(phase), dim=-1))
    return torch.cat(parts, dim=1).reshape(b, n_frames * up)


class SurrogateAdditive(Processor):
    """The surrogate inharmonic synth (surrogate.py:120-190): scaled
    amplitudes and harmonic distribution, stiff-string partials, decays
    clipped to [1e-5, 1] and set to 1 at or above Nyquist; one f0, so the
    partials are the harmonic distribution's, in order."""

    def __init__(self, frame_rate: int = 250, sample_rate: int = 16000,
                 min_frequency: float = 20.0,
                 normalize_harm_distribution: bool = True,
                 scale_fn: Optional[Callable] = exp_tanh,
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
        decays = clip(core.f32(decays), 1e-5, 1.0)
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

    def get_signal(self, amplitudes, decays, decay_time,
                   harmonic_distribution, harmonic_shifts, f0_hz):
        k = core.harmonic_numbers(harmonic_distribution.shape[-1],
                                  f0_hz.device)
        freqs = core.f32(f0_hz) * k * (1.0 + harmonic_shifts)
        amps = core.f32(amplitudes) * harmonic_distribution
        controls = framewise_osc_controls(freqs, amps, self.upsampling,
                                          self.sample_rate)
        return render_framewise_decay(controls, decays, decay_time,
                                      self.upsampling, self.sample_rate)


class SurrogateModule(nn.DictModule):
    """Per-pitch partial decays (an embedding of the pitch's integer part)
    and the frames since the last onset: t[i] = i - (the last onset at or
    before i), i + 1 before any onset (surrogate.gin's recurrent cell, in
    closed form)."""

    input_keys = ('conditioning', 'extended_pitch')
    output_keys = ('decays', 'decay_time')

    def __init__(self, n_harmonics=96):
        super().__init__()
        self.amp_model = nn.Embedding(128, n_harmonics,
                                      embeddings_init='ones')

    def reset_parameters(self, generator: torch.Generator):
        """The decay table from the seed (the module docstring says
        why)."""
        shape = self.amp_model.embeddings.shape
        u = -5.0 + 2.0 * torch.rand(shape, generator=generator,
                                    dtype=torch.float64)
        with torch.no_grad():
            self.amp_model.embeddings.copy_((1.0 - 10.0 ** u).float())

    def forward(self, conditioning, extended_pitch):
        decays = self.amp_model(extended_pitch[..., 0])
        onset = conditioning[..., 1:2]                        # (b, t, 1)
        b, t, _ = onset.shape
        idx = torch.arange(t, dtype=torch.float32,
                           device=onset.device)[None, :, None]
        marked = torch.where(onset > 0, idx.expand(b, t, 1),
                             torch.full_like(onset, -math.inf))
        last_onset = torch.cummax(marked, dim=1).values
        decay_time = torch.where(torch.isfinite(last_onset),
                                 idx - last_onset, idx + 1.0)
        return decays, decay_time


class DeepDetuner(nn.DictModule):
    """One f0 per substring: midi_to_hz(pitch + tanh(MLP(pitch / 128)) +
    tanh(global_detuning)), the output layer zero-initialised. Without
    ``use_detune`` (phase 1 of training) every substring sits at the
    pitch."""

    input_keys = ('extended_pitch', 'global_detuning?')
    output_keys = ('f0_hz',)

    def __init__(self, n_substrings=2, use_detune=True, ch=32, n_layers=3):
        super().__init__()
        self.use_detune = use_detune
        self.hidden_layers = nn.FcStack(ch, 1, layers=n_layers)
        self.out_layer = nn.Dense(n_substrings, ch, activation='tanh',
                                  kernel_init='zeros')

    def forward(self, extended_pitch, global_detuning=None):
        extended_pitch = core.f32(extended_pitch)
        if self.use_detune:
            detuning = self.out_layer(
                self.hidden_layers(extended_pitch / MIDI_NORM))
            if global_detuning is not None:
                detuning = detuning + core.rounded(torch.tanh,
                                                   global_detuning)
            extended_pitch = extended_pitch + detuning
        return core.midi_to_hz(extended_pitch)


class InharmonicityLoss(Loss):
    """weight x the sum of the negative parts of outputs['inharm_coef'],
    over its leading axis (losses.py:101-111)."""

    def __init__(self, weight: float = 10.0,
                 name: str = 'inharmonicity_loss'):
        super().__init__(name=name)
        self.weight = weight

    def compute(self, outputs):
        inharm = outputs['inharm_coef']
        loss = torch.sum(core.maximum(-inharm, 0.0)) / inharm.shape[0]
        return self.weight * loss


class SurrogatePianoModel(PianoModel):
    """PianoModel with the surrogate_module slot after the monophonic
    network (the JAX package's slot order), trained in the second phase
    only, as the frequency modules are (piano_model.py:28-33)."""

    MONO_SLOTS = PianoModel.MONO_SLOTS + ('surrogate_module',)

    def trainable_mask(self, first_phase: Optional[bool] = None
                       ) -> Dict[str, bool]:
        mask = super().trainable_mask(first_phase)
        for name in mask:
            if name.startswith('surrogate_module.'):
                mask[name] = first_phase is None or not first_phase
        return mask
