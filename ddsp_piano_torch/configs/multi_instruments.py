"""Ten-instrument model at 16 kHz.

Counterpart of ddsp_piano_tpu/configs/multi_instruments.py
(multi_instruments.gin): a ContextNetwork on normalized pitches, a
MonophonicDeepNetwork with 192 channels, DictInharmonicityModel (a B per
pitch, negative values penalised), a one-substring Detuner, exp_tanh
scaling, a learned IR per instrument, a wet-only reverb (no dry add) and
the reverb regulariser.
"""

from __future__ import annotations

from ddsp_piano_torch import nn, processors
from ddsp_piano_torch.configs.registry import register
from ddsp_piano_torch.models import (Parallelizer, PianoModel,
                                     VectorizedPolyphonicProcessorGroup)
from ddsp_piano_torch.models import losses as losses_lib
from ddsp_piano_torch.models import sub_modules as sm
from ddsp_piano_torch.ops import core


@register('multi_instruments')
def build(inference: bool = False,
          duration: float = 3.0,
          sample_rate: int = 16000,
          frame_rate: int = 250,
          n_instruments: int = 10,
          n_synths: int = 16,
          reverb_duration: float = 1.5,
          z_dim: int = 16,
          n_harmonics: int = 96,
          n_noise_bands: int = 64,
          first_phase: bool = True,
          oscillator: str = 'skip') -> PianoModel:
    """The model, weights uninitialised (see configs.get_model). The z
    encoder is built for ``duration`` seconds of frames; the Detuner
    detunes at inference and in the second training phase. ``oscillator``:
    'skip' (K1) or 'full' (K8, forward only)."""
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
        reverb=processors.Reverb(add_dry=False),
        reverb_controls=('reverb_ir',),
        n_synths=n_synths,
    )
    return PianoModel(
        z_encoder=sm.OneHotZEncoder(n_instruments=n_instruments, z_dim=z_dim,
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
        monophonic_network=sm.MonophonicDeepNetwork(
            rnn_channels=192, ch=192, layers_per_stack=3, context_dim=32,
            output_splits=(('amplitudes', 1),
                           ('harmonic_distribution', n_harmonics),
                           ('magnitudes', n_noise_bands))),
        inharm_model=sm.DictInharmonicityModel(n_instruments=n_instruments),
        detuner=sm.Detuner(n_substrings=1,
                           use_detune=True if inference else not first_phase),
        reverb_model=sm.MultiInstrumentReverb(
            n_instruments=n_instruments, reverb_duration=reverb_duration,
            sample_rate=sample_rate, inference=inference),
        processor_group=processor_group,
        losses=[
            losses_lib.SpectralLoss(loss_type='L1', mag_weight=1.0,
                                    logmag_weight=1.0,
                                    sample_rate=sample_rate,
                                    name='audio_stft_loss'),
            losses_lib.ReverbRegularizer(name='reverb_regularizer'),
        ],
    )
