"""ENSTDkCl single-instrument model at 32 kHz.

Counterpart of ddsp_piano_tpu/configs/enstdkcl_32khz.py
(ENSTDkCl-32kHz.gin): a one-instrument OneHotZEncoder, a ContextNetwork on
normalized pitches (Dense32 -> GRU64 -> Normalize), a MonophonicNetwork
without Normalize (Dense128 -> GRU192 -> Dense192), ParametricTuning,
192 harmonics and 128 noise bands scaled by exp_tanh, and a trainable
standalone FDN reverb with 6 trainable delay lines.
"""

from __future__ import annotations

from ddsp_piano_torch import nn, processors
from ddsp_piano_torch.configs.registry import register
from ddsp_piano_torch.models import (Parallelizer, PianoModel,
                                     VectorizedPolyphonicProcessorGroup)
from ddsp_piano_torch.models import losses as losses_lib
from ddsp_piano_torch.models import sub_modules as sm
from ddsp_piano_torch.ops import core


@register('enstdkcl_32khz')
def build(inference: bool = False,
          duration: float = 3.0,
          sample_rate: int = 32000,
          frame_rate: int = 250,
          n_synths: int = 16,
          z_dim: int = 16,
          n_harmonics: int = 192,
          n_noise_bands: int = 128,
          delay_lines: int = 6,
          first_phase: bool = True,
          oscillator: str = 'skip') -> PianoModel:
    """The model, weights uninitialised (see configs.get_model). The z
    encoder is built for ``duration`` seconds of frames; ``inference`` and
    ``first_phase`` change nothing here (no detuner, no learned IR), as in
    the JAX builder. ``oscillator``: 'skip' (K1) or 'full' (K8, forward
    only)."""
    del inference, first_phase
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
        z_encoder=sm.OneHotZEncoder(n_instruments=1, z_dim=z_dim,
                                    duration=duration,
                                    frame_rate=frame_rate),
        note_release=sm.NoteRelease(frame_rate=frame_rate),
        context_network=sm.ContextNetwork(
            layers=[nn.Dense(32, n_synths * 2 + 4 + z_dim,
                             activation='leaky_relu'),
                    nn.GRU(64, 32),
                    nn.Normalize(64)],
            out_features=64,
            normalize_pitch=True),
        parallelizer=Parallelizer(n_synths=n_synths),
        monophonic_network=sm.MonophonicNetwork(
            layers=[nn.Dense(128, 35, activation='leaky_relu'),
                    nn.GRU(192, 128),
                    nn.Dense(192, 192, activation='leaky_relu')],
            out_features=192,
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
