"""Synthesis processors (counterpart of ddsp_piano_tpu/processors)."""

from ddsp_piano_torch.processors.base import Processor
from ddsp_piano_torch.processors.inharm import InHarmonic, MultiInharmonic
from ddsp_piano_torch.processors.noise import (DynamicSizeFilteredNoise,
                                               FilteredNoise)
from ddsp_piano_torch.processors.reverb import FeedbackDelayNetwork, Reverb
from ddsp_piano_torch.processors.surrogate import SurrogateAdditive

__all__ = ['DynamicSizeFilteredNoise', 'FeedbackDelayNetwork',
           'FilteredNoise', 'InHarmonic', 'MultiInharmonic', 'Processor',
           'Reverb', 'SurrogateAdditive']
