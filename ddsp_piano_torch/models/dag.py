"""The polyphonic processor groups: the folded-voice group (all voices
through one oscillator call and one noise call, summed, then
reverberated) and the reference's sequential per-voice DAG.

Counterpart of ddsp_piano_tpu/models/dag.py: polyphonic_dag (:23-50) and
VectorizedPolyphonicProcessorGroup (:53-155). The two compute the same
per-voice audio and differ in the order of the voice sum.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ddsp_piano_torch.processors.base import (MultiAdd, Processor,
                                              ProcessorGroup)


def polyphonic_dag(additive: Processor, noise: Processor,
                   reverb: Optional[Processor] = None,
                   additive_controls: Sequence[str] = (
                       'amplitudes', 'harmonic_distribution', 'inharm_coef',
                       'f0_hz'),
                   noise_controls: Sequence[str] = ('magnitudes',),
                   reverb_controls: Sequence[str] = (),
                   n_synths: int = 16
                   ) -> List[Tuple[Processor, List[str]]]:
    """The reference's per-voice DAG for a ProcessorGroup: for each voice
    i, the additive synth on '<control>_i', the noise synth, and a MultiAdd
    'add' of the running sum, the noise and the additive signal; then the
    reverb on 'add/signal'."""
    add = MultiAdd(name='add')
    dag: List[Tuple[Processor, List[str]]] = [
        (additive, [c + '_0' for c in additive_controls]),
        (noise, [c + '_0' for c in noise_controls]),
        (add, [noise.name + '/signal', additive.name + '/signal'])]
    for i in range(1, n_synths):
        dag.append((additive, [c + f'_{i}' for c in additive_controls]))
        dag.append((noise, [c + f'_{i}' for c in noise_controls]))
        dag.append((add, ['add/signal', noise.name + '/signal',
                          additive.name + '/signal']))
    if reverb is not None:
        dag.append((reverb, ['add/signal'] + list(reverb_controls)))
    return dag


class VectorizedPolyphonicProcessorGroup(nn.Module):

    def __init__(self, additive: Processor, noise: Processor,
                 reverb: Optional[Processor] = None,
                 additive_controls: Sequence[str] = (
                     'amplitudes', 'harmonic_distribution', 'inharm_coef',
                     'f0_hz'),
                 noise_controls: Sequence[str] = ('magnitudes',),
                 reverb_controls: Sequence[str] = ('reverb_ir',),
                 n_synths: int = 16):
        super().__init__()
        self.additive = additive
        self.noise = noise
        # The reverb sits under its processor's name, as in the JAX params
        # tree: 'reverb', or the standalone FDN's 'DelayNetwork'.
        self.reverb_name = 'reverb' if reverb is None else reverb.name
        self._modules[self.reverb_name] = reverb
        self.additive_controls = tuple(additive_controls)
        self.noise_controls = tuple(noise_controls)
        self.reverb_controls = tuple(reverb_controls)
        self.n_synths = n_synths

    @property
    def reverb(self) -> Optional[Processor]:
        return self._modules[self.reverb_name]

    @property
    def processors(self):
        return [p for p in (self.additive, self.noise, self.reverb)
                if p is not None]

    def as_sequential_group(self) -> ProcessorGroup:
        """A ProcessorGroup over :func:`polyphonic_dag` of the same
        processors (shared, so with the same parameters). Fed the same
        noise tensor, each voice gets its rows of the folded draw."""
        return ProcessorGroup(polyphonic_dag(
            self.additive, self.noise, self.reverb, self.additive_controls,
            self.noise_controls, self.reverb_controls, self.n_synths))

    @staticmethod
    def _fold(stacked: torch.Tensor) -> torch.Tensor:
        """(n_synths, batch, ...) -> (n_synths * batch, ...)."""
        return stacked.reshape((-1,) + tuple(stacked.shape[2:]))

    def forward(self, features: Dict[str, torch.Tensor],
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """features hold the stacked mono controls (n_synths, batch, ...)
        plus the reverb controls. ``noise`` optionally injects the
        (n_synths * batch, n_samples) uniform draw of the noise synth.

        Returns {'signal': wet audio, 'add': {'signal': dry audio}, ...}.
        """
        outputs = dict(features)
        batch = features[self.additive_controls[0]].shape[1]

        add_ctrl = self.additive.get_controls(
            *(self._fold(features[c]) for c in self.additive_controls))
        sig_add = self.additive.get_signal(**add_ctrl)
        noise_ctrl = self.noise.get_controls(
            *(self._fold(features[c]) for c in self.noise_controls))
        sig_noise = self.noise.get_signal(**noise_ctrl, noise=noise,
                                          generator=generator)
        n_samples = sig_add.shape[-1]
        mix = (sig_add + sig_noise).reshape(
            self.n_synths, batch, n_samples).sum(dim=0)
        # As the sequential DAG leaves them: the last voice's entries.
        last = slice((self.n_synths - 1) * batch, self.n_synths * batch)
        for proc, sig, ctrl in ((self.additive, sig_add, add_ctrl),
                                (self.noise, sig_noise, noise_ctrl)):
            outputs[proc.name] = {'signal': sig[last], 'controls': {
                k: v[last] for k, v in ctrl.items()}}
        outputs['add'] = {'signal': mix}

        signal = mix
        if self.reverb is not None:
            rev_ctrl = self.reverb.get_controls(
                mix, *(features[c] for c in self.reverb_controls))
            signal = self.reverb.get_signal(**rev_ctrl)
            outputs[self.reverb.name] = {'signal': signal,
                                         'controls': rev_ctrl}
        outputs['out'] = {'signal': signal}
        return {'signal': signal, 'controls': outputs}
