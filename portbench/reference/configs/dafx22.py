"""DAFx-22 paper model configuration.

Counterpart of ddsp_piano_tpu/configs/dafx22.py:20-103 (dafx22.gin): 16 kHz,
OneHotZEncoder + ContextNetwork + MonophonicNetwork + InharmonicityNetwork
+ Detuner (2 substrings) + MultiInstrumentReverb, trained on the
multi-scale spectral loss plus the reverb regulariser. ``dafx22_24khz`` is
the same model at 24 kHz with 128 harmonics and 96 noise bands
(dafx22-24kHz.gin).
"""

from __future__ import annotations

from portbench.reference import nn, processors
from portbench.reference.configs import register
from portbench.reference.models import (Parallelizer, PianoModel,
                                     VectorizedPolyphonicProcessorGroup)
from portbench.reference.models import losses as losses_lib
from portbench.reference.models import sub_modules as sm


@register('dafx22')
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
    """The dafx22 model, weights uninitialised (see configs.get_model).
    OneHotZEncoder resamples to ``duration`` seconds of frames, so the model
    renders inputs of exactly that length. The Detuner detunes at inference
    and in the second training phase. ``oscillator``: 'skip' (K1) or 'full'
    (K8, forward only), processors.MultiInharmonic's."""
    context_in = n_synths * 2 + 4 + z_dim           # 52
    mono_in = 1 + 2 + 32                            # 35
    processor_group = VectorizedPolyphonicProcessorGroup(
        additive=processors.MultiInharmonic(name='additive',
                                            frame_rate=frame_rate,
                                            sample_rate=sample_rate,
                                            oscillator=oscillator),
        noise=processors.DynamicSizeFilteredNoise(name='noise',
                                                  frame_rate=frame_rate,
                                                  sample_rate=sample_rate),
        reverb=processors.Reverb(),
        additive_controls=('amplitudes', 'harmonic_distribution',
                           'inharm_coef', 'f0_hz'),
        noise_controls=('magnitudes',),
        reverb_controls=('reverb_ir',),
        n_synths=n_synths,
    )
    return PianoModel(
        z_encoder=sm.OneHotZEncoder(n_instruments=n_instruments, z_dim=z_dim,
                                    duration=duration,
                                    frame_rate=frame_rate),
        note_release=sm.NoteRelease(frame_rate=frame_rate),
        context_network=sm.ContextNetwork(
            layers=[nn.Dense(32, context_in, activation='leaky_relu'),
                    nn.GRU(64, 32),
                    nn.Normalize(64)],
            out_features=64,
            output_splits=(('context', 32),)),
        parallelizer=Parallelizer(n_synths=n_synths),
        monophonic_network=sm.MonophonicNetwork(
            layers=[nn.Dense(128, mono_in, activation='leaky_relu'),
                    nn.GRU(192, 128),
                    nn.Dense(192, 192, activation='leaky_relu'),
                    nn.Normalize(192)],
            out_features=192,
            output_splits=(('amplitudes', 1),
                           ('harmonic_distribution', n_harmonics),
                           ('magnitudes', n_noise_bands))),
        inharm_model=sm.InharmonicityNetwork(),
        detuner=sm.Detuner(n_substrings=2,
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
