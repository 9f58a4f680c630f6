"""Synthesis processors (counterpart of ddsp_piano_tpu/processors)."""

from portbench.reference.processors.base import Processor
from portbench.reference.processors.inharm import InHarmonic, MultiInharmonic
from portbench.reference.processors.noise import (DynamicSizeFilteredNoise,
                                               FilteredNoise)
from portbench.reference.processors.reverb import FeedbackDelayNetwork, Reverb

__all__ = ['DynamicSizeFilteredNoise', 'FeedbackDelayNetwork',
           'FilteredNoise', 'InHarmonic', 'MultiInharmonic', 'Processor',
           'Reverb']
