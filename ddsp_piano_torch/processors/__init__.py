"""Synthesis processors (counterpart of ddsp_piano_tpu/processors)."""

from ddsp_piano_torch.processors.base import (Add, MultiAdd, Processor,
                                              ProcessorGroup, nested_lookup)
from ddsp_piano_torch.processors.inharm import InHarmonic, MultiInharmonic
from ddsp_piano_torch.processors.noise import (DynamicSizeFilteredNoise,
                                               FilterBank, FilteredNoise,
                                               NoiseBandNetSynth,
                                               get_noise_bands)
from ddsp_piano_torch.processors.reverb import FeedbackDelayNetwork, Reverb
from ddsp_piano_torch.processors.surrogate import SurrogateAdditive

__all__ = ['Add', 'DynamicSizeFilteredNoise', 'FeedbackDelayNetwork',
           'FilterBank', 'FilteredNoise', 'InHarmonic', 'MultiAdd',
           'MultiInharmonic', 'NoiseBandNetSynth', 'Processor',
           'ProcessorGroup', 'Reverb', 'SurrogateAdditive',
           'get_noise_bands', 'nested_lookup']
