"""Piano model and its losses (counterpart of ddsp_piano_tpu/models)."""

from portbench.reference.models.dag import VectorizedPolyphonicProcessorGroup
from portbench.reference.models.piano_model import PianoModel
from portbench.reference.models.sub_modules import Parallelizer

__all__ = ['Parallelizer', 'PianoModel', 'VectorizedPolyphonicProcessorGroup']
