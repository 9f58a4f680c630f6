"""The paper model assembled in Python, without a config system.

Counterpart of ddsp_piano_tpu/models/default_model.py:
``build_polyphonic_processor_group`` (the additive, filtered-noise and
reverb group, folded-voice or as the reference's sequential per-voice
DAG), ``get_model`` (the DAFx-22 model, the registered dafx22 config) and
``build_model`` (initial weights, checked by a forward on a dummy batch).
"""

from __future__ import annotations

from ddsp_piano_torch import processors
from ddsp_piano_torch.device import DeviceLike
from ddsp_piano_torch.models.dag import (VectorizedPolyphonicProcessorGroup,
                                         polyphonic_dag)
from ddsp_piano_torch.processors.base import ProcessorGroup


def build_polyphonic_processor_group(n_synths: int = 16,
                                     sample_rate: int = 16000,
                                     frame_rate: int = 250,
                                     inference: bool = False,
                                     add_dry: bool = True,
                                     vectorized: bool = True,
                                     name: str = 'processor_group'):
    """The polyphonic additive + filtered-noise + reverb group: the
    folded-voice group, or with ``vectorized=False`` a ProcessorGroup over
    the sequential per-voice DAG."""
    additive = processors.MultiInharmonic(name='additive',
                                          frame_rate=frame_rate,
                                          sample_rate=sample_rate,
                                          inference=inference)
    noise = processors.DynamicSizeFilteredNoise(name='noise',
                                                frame_rate=frame_rate,
                                                sample_rate=sample_rate)
    reverb = processors.Reverb(trainable=False, add_dry=add_dry)
    controls = ('amplitudes', 'harmonic_distribution', 'inharm_coef',
                'f0_hz')
    if vectorized:
        return VectorizedPolyphonicProcessorGroup(
            additive=additive, noise=noise, reverb=reverb,
            additive_controls=controls, noise_controls=('magnitudes',),
            reverb_controls=('reverb_ir',), n_synths=n_synths)
    dag = polyphonic_dag(additive, noise, reverb, additive_controls=controls,
                         noise_controls=('magnitudes',),
                         reverb_controls=('reverb_ir',), n_synths=n_synths)
    return ProcessorGroup(dag, name=name)


def get_model(duration: float = 3.0, n_synths: int = 16,
              n_substrings: int = 2, n_piano_models: int = 10,
              piano_embedding_dim: int = 16, n_noise_filter_banks: int = 64,
              frame_rate: int = 250, sample_rate: int = 16000,
              reverb_duration: float = 1.5, inference: bool = False,
              first_phase: bool = True):
    """The DAFx-22 paper model, weights uninitialised (build_model gives
    them)."""
    del n_substrings
    from ddsp_piano_torch.configs.dafx22 import build
    return build(inference=inference, duration=duration,
                 sample_rate=sample_rate, frame_rate=frame_rate,
                 n_instruments=n_piano_models, n_synths=n_synths,
                 reverb_duration=reverb_duration,
                 z_dim=piano_embedding_dim,
                 n_noise_bands=n_noise_filter_banks,
                 first_phase=first_phase)


def build_model(model, batch_size: int = 6, duration: float = 3.0,
                sample_rate: int = 16000, first_phase: bool = True,
                seed: int = 0, device: DeviceLike = None):
    """Keras-style initial weights from ``seed`` on ``device`` (default
    cuda), checked by one forward on a dummy batch of the given shape.
    Returns the model."""
    import torch

    from ddsp_piano_torch.data.pipeline import get_dummy_data
    from ddsp_piano_torch.device import resolve_device
    from ddsp_piano_torch.nn import init_weights

    del first_phase
    device = resolve_device(device)
    model = init_weights(model, seed).to(device).eval()
    feats = get_dummy_data(batch_size=batch_size, duration=duration,
                           sample_rate=sample_rate,
                           frame_rate=model.frame_rate,
                           n_synths=model.n_synths)
    batch = {k: torch.from_numpy(v).to(device) for k, v in feats.items()}
    with torch.no_grad():
        outs = model(batch, generator=torch.Generator(
            device=device).manual_seed(0))
    assert tuple(outs['audio_synth'].shape) == (
        batch_size, int(duration * sample_rate))
    return model
