"""ENSTDkCl single-instrument model at 8 kHz.

Counterpart of ddsp_piano_tpu/configs/enstdkcl_8khz.py (ENSTDkCl-8kHz.gin):
no z encoder and no detuner; a pedal-only SimpleContextNet (Dense32 ->
GRU32 -> Normalize), a MonophonicNetwork (Dense128 -> GRU128 -> Dense128),
ParametricTuning, 48 harmonics and 32 noise bands scaled by exp_tanh, and
a trainable standalone FDN reverb with 8 trainable delay lines.
"""

from __future__ import annotations

from ddsp_piano_torch import nn, processors
from ddsp_piano_torch.configs.registry import register
from ddsp_piano_torch.models import (Parallelizer, PianoModel,
                                     VectorizedPolyphonicProcessorGroup)
from ddsp_piano_torch.models import losses as losses_lib
from ddsp_piano_torch.models import sub_modules as sm
from ddsp_piano_torch.ops import core


@register('enstdkcl_8khz')
def build(inference: bool = False,
          duration: float = 3.0,
          sample_rate: int = 8000,
          frame_rate: int = 250,
          n_synths: int = 16,
          n_harmonics: int = 48,
          n_noise_bands: int = 32,
          delay_lines: int = 8,
          first_phase: bool = True,
          oscillator: str = 'skip') -> PianoModel:
    """The model, weights uninitialised (see configs.get_model).
    ``inference``, ``duration`` and ``first_phase`` change nothing here
    (no z encoder, no detuner), as in the JAX builder. ``oscillator``:
    'skip' (K1) or 'full' (K8, forward only)."""
    del inference, duration, first_phase
    processor_group = VectorizedPolyphonicProcessorGroup(
        additive=processors.MultiInharmonic(
            name='additive',
            frame_rate=frame_rate, sample_rate=sample_rate,
            scale_fn=core.exp_tanh, normalize_after_nyquist_cut=False,
            oscillator=oscillator),
        noise=processors.DynamicSizeFilteredNoise(
            name='noise',
            frame_rate=frame_rate, sample_rate=sample_rate,
            scale_fn=core.exp_tanh),
        reverb=processors.FeedbackDelayNetwork(
            trainable=True, delay_trainable=True, delay_lines=delay_lines,
            sampling_rate=sample_rate),
        reverb_controls=(),
        n_synths=n_synths,
    )
    return PianoModel(
        note_release=sm.NoteRelease(frame_rate=frame_rate),
        context_network=sm.SimpleContextNet(
            layers=[nn.Dense(32, 4, activation='leaky_relu'),
                    nn.GRU(32, 32),
                    nn.Normalize(32)],
            out_features=32),
        parallelizer=Parallelizer(n_synths=n_synths,
                                  global_keys=('conditioning', 'context')),
        monophonic_network=sm.MonophonicNetwork(
            layers=[nn.Dense(128, 35, activation='leaky_relu'),
                    nn.GRU(128, 128),
                    nn.Dense(128, 128, activation='leaky_relu')],
            out_features=128,
            output_splits=(('amplitudes', 1),
                           ('harmonic_distribution', n_harmonics),
                           ('magnitudes', n_noise_bands))),
        inharm_model=sm.ParametricTuning(),
        processor_group=processor_group,
        losses=[
            losses_lib.SpectralLoss(loss_type='L1', mag_weight=1.0,
                                    logmag_weight=1.0,
                                    sample_rate=sample_rate,
                                    name='audio_stft_loss'),
        ],
    )
