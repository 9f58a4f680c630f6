"""PianoModel: MIDI conditioning -> audio, and the training losses.

Counterpart of ddsp_piano_tpu/models/piano_model.py: global slots, then
parallelize, then mono slots, then unparallelize, then the processor group
(:184-245); in training, the losses (:238-245). Phase-dependent
trainability (:105-180) is a per-parameter ``requires_grad`` rule
(:meth:`PianoModel.set_trainable`), which the trainer's optimizer follows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn

from ddsp_piano_torch.models.dag import VectorizedPolyphonicProcessorGroup
from ddsp_piano_torch.models.losses import Loss
from ddsp_piano_torch.models.sub_modules import (InharmonicityNetwork,
                                                 JointParametricInharmTuning,
                                                 OneHotZEncoder, Parallelizer)
from ddsp_piano_torch.processors.base import ProcessorGroup

# Slots whose parameters train in the second phase only (the frequency
# modules) and in the first phase only (piano_model.py:28-33).
_SECOND_PHASE_MODULES = ('inharm_model', 'detuner', 'surrogate_module')
_FIRST_PHASE_MODULES = ('note_release', 'context_network',
                        'background_noise_model', 'monophonic_network',
                        'reverb_model')


class PianoModel(nn.Module):
    """Polyphonic differentiable piano synthesizer."""

    # The JAX package's slots, in its order (piano_model.py:39-43).
    GLOBAL_SLOTS = ('z_encoder', 'context_network', 'background_noise_model',
                    'reverb_model')
    MONO_SLOTS = ('note_release', 'inharm_model', 'detuner',
                  'monophonic_network', 'surrogate_module',
                  'harmonic_masking')

    def __init__(self, parallelizer: Parallelizer,
                 processor_group: Union[VectorizedPolyphonicProcessorGroup,
                                        ProcessorGroup],
                 losses: Optional[List[Loss]] = None,
                 **slots: Optional[nn.Module]):
        super().__init__()
        unknown = set(slots) - set(self.GLOBAL_SLOTS + self.MONO_SLOTS)
        if unknown:
            raise ValueError(f"Unknown PianoModel slots: {sorted(unknown)}")
        for slot in self.GLOBAL_SLOTS + self.MONO_SLOTS:
            setattr(self, slot, slots.get(slot))
        self.parallelizer = parallelizer
        self.processor_group = processor_group
        self.loss_objs = list(losses) if losses else []

    @property
    def n_synths(self) -> int:
        return self.parallelizer.n_synths

    @property
    def sample_rate(self) -> int:
        return self.processor_group.processors[0].sample_rate

    @property
    def frame_rate(self) -> int:
        return self.processor_group.processors[0].frame_rate

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _module_slots(self):
        for slot in self.GLOBAL_SLOTS + self.MONO_SLOTS:
            module = getattr(self, slot)
            if module is not None:
                yield slot, module

    def trainable_mask(self, first_phase: Optional[bool] = None
                       ) -> Dict[str, bool]:
        """{parameter name: trainable} for a phase (None: every phase).

        Pretrained JointParametricInharmTuning weights stay frozen in every
        phase; otherwise first-phase slots train in phase 1 and the
        frequency slots in phase 2 (piano_model.py:105-180). Two modules
        split (:147-171): OneHotZEncoder's z ``embedding`` trains in phase
        1 and its inharm/detune embeddings in phase 2;
        InharmonicityNetwork's (and ParametricTuning's) slopes and offsets
        are frozen in every phase. The processor group's parameters (the
        ENSTDkCl models' FDN reverb) train in every phase."""
        mask = {}
        for slot, module in self._module_slots():
            if (isinstance(module, JointParametricInharmTuning)
                    and module.pretrained_weights is not None):
                trainable = False
            elif first_phase is None:
                trainable = True
            elif slot in _SECOND_PHASE_MODULES:
                trainable = not first_phase
            elif slot in _FIRST_PHASE_MODULES:
                trainable = first_phase
            else:
                trainable = True
            for name, _ in module.named_parameters():
                leaf = trainable
                if (isinstance(module, OneHotZEncoder)
                        and first_phase is not None):
                    leaf = first_phase == name.startswith('embedding.')
                elif isinstance(module, InharmonicityNetwork):
                    leaf = trainable and name not in module.FROZEN
                mask[f'{slot}.{name}'] = leaf
        for name, _ in self.processor_group.named_parameters(
                prefix='processor_group'):
            mask[name] = True
        return mask

    def set_trainable(self, first_phase: Optional[bool] = None
                      ) -> Dict[str, bool]:
        """Set each parameter's requires_grad from trainable_mask."""
        mask = self.trainable_mask(first_phase)
        for name, param in self.named_parameters():
            param.requires_grad_(mask[name])
        return mask

    def _apply_slots(self, slots, features):
        for slot in slots:
            module = getattr(self, slot)
            if module is not None:
                features.update(module.apply_features(features))
        return features

    def regularization_loss(self) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for _, module in self._module_slots():
            reg = getattr(module, 'regularization', None)
            if reg is not None:
                total = total + reg()
        return total

    def loss_keys(self):
        return ([loss.name for loss in self.loss_objs]
                + ['regularization_loss', 'total_loss'])

    def forward(self, features: Dict[str, Any],
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                training: bool = False,
                use_sequential_dag: bool = False) -> Dict[str, Any]:
        """features: conditioning (b, t, n_synths, 2), pedal (b, t, 4),
        piano_model (b, 1) int, and in training the target audio (b, n).
        Returns the outputs dict with 'audio_synth' (wet), 'add':
        {'signal'} (the dry stem) and, in training, 'losses'.
        ``use_sequential_dag`` renders a folded-voice group through its
        per-voice DAG (piano_model.py:212-222); the noise draw is split by
        voice (processors.base)."""
        features = dict(features)
        batch_size = features['conditioning'].shape[0]
        features = self._apply_slots(self.GLOBAL_SLOTS, features)
        features = self.parallelizer.parallelize(features)
        features = self._apply_slots(self.MONO_SLOTS, features)
        features = self.parallelizer.unparallelize(features, batch_size)
        group = self.processor_group
        if use_sequential_dag and isinstance(
                group, VectorizedPolyphonicProcessorGroup):
            group = group.as_sequential_group()
        if isinstance(group, ProcessorGroup):
            features = self.parallelizer.voice_views(features)
        pg_out = group(features, noise=noise, generator=generator)
        outputs = pg_out['controls']
        outputs['audio_synth'] = pg_out['signal']
        if training:
            losses = {loss.name: loss.compute(outputs)
                      for loss in self.loss_objs}
            losses['regularization_loss'] = self.regularization_loss()
            losses['total_loss'] = sum(losses.values())
            outputs['losses'] = losses
        return outputs
