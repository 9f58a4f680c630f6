"""Piano model and its losses (counterpart of ddsp_piano_tpu/models)."""

from ddsp_piano_torch.models.dag import VectorizedPolyphonicProcessorGroup
from ddsp_piano_torch.models.piano_model import PianoModel
from ddsp_piano_torch.models.sub_modules import Parallelizer

__all__ = ['Parallelizer', 'PianoModel', 'VectorizedPolyphonicProcessorGroup']
