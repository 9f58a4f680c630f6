"""Surrogate-synthesis model at 16 kHz.

Counterpart of ddsp_piano_tpu/configs/surrogate.py (surrogate.gin): the
SurrogateAdditive synth (partials with decay envelopes) fed by a
SurrogateModule, a DeepDetuner, the InharmonicityNetwork and the
inharmonicity loss; the mono network puts a Normalize between its input
Dense and its GRU, and the Parallelizer carries decays and decay_time as
mono keys. One instrument, a 1 s learned IR.
"""

from __future__ import annotations

from ddsp_piano_torch import nn, processors
from ddsp_piano_torch.configs.registry import register
from ddsp_piano_torch.models import (Parallelizer, PianoModel,
                                     VectorizedPolyphonicProcessorGroup)
from ddsp_piano_torch.models import losses as losses_lib
from ddsp_piano_torch.models import sub_modules as sm
from ddsp_piano_torch.ops import core


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
          first_phase: bool = True,
          oscillator: str = 'skip') -> PianoModel:
    """The model, weights uninitialised (see configs.get_model). The
    surrogate synth renders its decaying partials in plain torch, as the
    JAX package does in jnp: no oscillator kernel takes them, so
    ``oscillator`` must stay 'skip' (the synthesize CLI's default)."""
    if oscillator != 'skip':
        raise ValueError(
            f"oscillator={oscillator!r}: the surrogate model renders its "
            "decaying partials in plain torch, with no oscillator kernel to "
            "choose; only the default 'skip' is accepted.")
    processor_group = VectorizedPolyphonicProcessorGroup(
        additive=processors.SurrogateAdditive(
            name='additive',
            frame_rate=frame_rate, sample_rate=sample_rate,
            scale_fn=core.exp_tanh, normalize_harm_distribution=False),
        noise=processors.DynamicSizeFilteredNoise(
            name='noise',
            frame_rate=frame_rate, sample_rate=sample_rate,
            scale_fn=core.exp_tanh),
        reverb=processors.Reverb(),
        additive_controls=('amplitudes', 'decays', 'decay_time',
                           'harmonic_distribution', 'inharm_coef', 'f0_hz'),
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
            out_features=64),
        parallelizer=Parallelizer(
            n_synths=n_synths,
            mono_keys=('f0_hz', 'inharm_coef', 'amplitudes', 'decays',
                       'decay_time', 'harmonic_distribution', 'magnitudes')),
        monophonic_network=sm.MonophonicNetwork(
            layers=[nn.Dense(128, 35, activation='leaky_relu'),
                    nn.Normalize(128),
                    nn.GRU(128, 128),
                    nn.Dense(128, 128, activation='leaky_relu')],
            out_features=128,
            output_splits=(('amplitudes', 1),
                           ('harmonic_distribution', n_harmonics),
                           ('magnitudes', n_noise_bands))),
        inharm_model=sm.InharmonicityNetwork(),
        detuner=sm.DeepDetuner(n_substrings=1,
                               use_detune=True if inference
                               else not first_phase),
        surrogate_module=sm.SurrogateModule(n_harmonics=n_harmonics),
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
            losses_lib.InharmonicityLoss(name='inharmonicity_regularizer'),
        ],
    )
