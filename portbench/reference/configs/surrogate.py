"""Surrogate-synthesis model configuration.

Counterpart of ddsp_piano_tpu/configs/surrogate.py (surrogate.gin): 16 kHz,
one instrument, OneHotZEncoder + ContextNetwork (Dense 32, GRU 64,
Normalize) + MonophonicNetwork (Dense 128, Normalize, GRU 128, Dense 128)
+ InharmonicityNetwork + DeepDetuner (one substring) + SurrogateModule +
MultiInstrumentReverb (a learned 1 s IR), the surrogate synth of decaying
partials (96) and filtered noise (64 bands), trained on the multi-scale
spectral loss, the reverb regulariser and the inharmonicity loss. The
only departure from surrogate.gin, the seeded decay table, is
models/surrogate.py's.
"""

from __future__ import annotations

from portbench.reference import nn, processors
from portbench.reference.configs import register
from portbench.reference.models import (Parallelizer,
                                        VectorizedPolyphonicProcessorGroup)
from portbench.reference.models import losses as losses_lib
from portbench.reference.models import sub_modules as sm
from portbench.reference.models import surrogate


@register('surrogate')
def build(inference: bool = False,
          duration: float = 3.0,
          sample_rate: int = 16000,
          frame_rate: int = 250,
          n_instruments: int = 1,
          n_synths: int = 16,
          z_dim: int = 16,
          n_harmonics: int = 96,
          n_noise_bands: int = 64,
          first_phase: bool = True) -> surrogate.SurrogatePianoModel:
    """The surrogate model, weights uninitialised (see configs.get_model).
    OneHotZEncoder resamples to ``duration`` seconds of frames. The
    DeepDetuner detunes at inference and in the second training phase."""
    context_in = n_synths * 2 + 4 + z_dim           # 52
    mono_in = 1 + 2 + 32                            # 35
    processor_group = VectorizedPolyphonicProcessorGroup(
        additive=surrogate.SurrogateAdditive(
            name='additive', frame_rate=frame_rate, sample_rate=sample_rate,
            scale_fn=surrogate.exp_tanh, normalize_harm_distribution=False),
        noise=processors.DynamicSizeFilteredNoise(
            name='noise', frame_rate=frame_rate, sample_rate=sample_rate,
            scale_fn=surrogate.exp_tanh),
        reverb=processors.Reverb(),
        additive_controls=('amplitudes', 'decays', 'decay_time',
                           'harmonic_distribution', 'inharm_coef', 'f0_hz'),
        noise_controls=('magnitudes',),
        reverb_controls=('reverb_ir',),
        n_synths=n_synths,
    )
    return surrogate.SurrogatePianoModel(
        z_encoder=sm.OneHotZEncoder(n_instruments=n_instruments, z_dim=z_dim,
                                    duration=duration,
                                    frame_rate=frame_rate),
        note_release=sm.NoteRelease(frame_rate=frame_rate),
        context_network=sm.ContextNetwork(
            layers=[nn.Dense(32, context_in, activation='leaky_relu'),
                    nn.GRU(64, 32),
                    nn.Normalize(64)],
            out_features=64),
        parallelizer=Parallelizer(
            n_synths=n_synths,
            mono_keys=('f0_hz', 'inharm_coef', 'amplitudes', 'decays',
                       'decay_time', 'harmonic_distribution', 'magnitudes')),
        monophonic_network=sm.MonophonicNetwork(
            layers=[nn.Dense(128, mono_in, activation='leaky_relu'),
                    nn.Normalize(128),
                    nn.GRU(128, 128),
                    nn.Dense(128, 128, activation='leaky_relu')],
            out_features=128,
            output_splits=(('amplitudes', 1),
                           ('harmonic_distribution', n_harmonics),
                           ('magnitudes', n_noise_bands))),
        inharm_model=sm.InharmonicityNetwork(),
        detuner=surrogate.DeepDetuner(
            n_substrings=1,
            use_detune=True if inference else not first_phase),
        surrogate_module=surrogate.SurrogateModule(n_harmonics=n_harmonics),
        reverb_model=sm.MultiInstrumentReverb(
            n_instruments=n_instruments, reverb_duration=1.0,
            sample_rate=sample_rate, inference=inference),
        processor_group=processor_group,
        losses=[
            losses_lib.SpectralLoss(loss_type='L1', mag_weight=1.0,
                                    logmag_weight=1.0,
                                    sample_rate=sample_rate,
                                    name='audio_stft_loss'),
            losses_lib.ReverbRegularizer(name='reverb_regularizer'),
            surrogate.InharmonicityLoss(name='inharmonicity_regularizer'),
        ],
    )
