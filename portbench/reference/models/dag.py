"""The folded-voice processor group: all voices through one oscillator
call and one noise call, summed, then reverberated.

Counterpart of ddsp_piano_tpu/models/dag.py's
VectorizedPolyphonicProcessorGroup (:53-155).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from portbench.reference.processors.base import Processor


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
        # As the JAX package's sequential DAG leaves them: the last voice's
        # entries.
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
