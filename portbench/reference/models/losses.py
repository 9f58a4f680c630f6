"""Training losses.

Counterpart of ddsp_piano_tpu/models/losses.py: Loss, SpectralLoss
(the v2 loss), ReverbRegularizer (dafx22, multi_instruments, surrogate),
InharmonicityLoss (surrogate) and LoudnessLoss (reached only through
``.gin`` files).
"""

from __future__ import annotations

from typing import Sequence

import torch

from portbench.reference.ops import core, spectral


class Loss:
    """A named loss: a subclass defines ``compute(outputs) -> tensor`` of
    the model outputs dict."""

    def __init__(self, name: str):
        self.name = name


class SpectralLoss(Loss):
    """Multi-resolution STFT loss between outputs['audio'] (the target) and
    a selected output key."""

    def __init__(self,
                 output_key: str = 'audio_synth',
                 extract_signal: bool = False,
                 fft_sizes: Sequence[int] = (2048, 1024, 512, 256, 128, 64),
                 loss_type: str = 'L1',
                 mag_weight: float = 1.0,
                 logmag_weight: float = 0.0,
                 delta_time_weight: float = 0.0,
                 delta_freq_weight: float = 0.0,
                 cumsum_freq_weight: float = 0.0,
                 sample_rate: int = 16000,
                 name: str = 'audio_stft_loss'):
        super().__init__(name=name)
        self.output_key = output_key
        self.extract_signal = extract_signal
        self.fft_sizes = tuple(fft_sizes)
        self.loss_type = loss_type
        self.mag_weight = mag_weight
        self.logmag_weight = logmag_weight
        self.delta_time_weight = delta_time_weight
        self.delta_freq_weight = delta_freq_weight
        self.cumsum_freq_weight = cumsum_freq_weight
        self.sample_rate = sample_rate

    def compute(self, outputs):
        audio_synth = outputs[self.output_key]
        if self.extract_signal:
            audio_synth = audio_synth['signal']
        return self._loss(outputs['audio'], audio_synth)

    def _loss(self, target_audio, audio_synth, per_element=False):
        return spectral.multi_scale_spectral_loss(
            target_audio, audio_synth,
            fft_sizes=self.fft_sizes,
            loss_type=self.loss_type,
            mag_weight=self.mag_weight,
            logmag_weight=self.logmag_weight,
            delta_time_weight=self.delta_time_weight,
            delta_freq_weight=self.delta_freq_weight,
            cumsum_freq_weight=self.cumsum_freq_weight,
            per_element=per_element)


class ReverbRegularizer(Loss):
    """L1 (or, with any other loss_type, L2) penalty on the reverb IR, per
    batch element."""

    def __init__(self, weight: float = 0.01, loss_type: str = 'L1',
                 name: str = 'reverb_regularizer'):
        super().__init__(name=name)
        self.weight = weight
        self.magnitude_order = (core.abs_ if loss_type == 'L1'
                                else torch.square)

    def compute(self, outputs):
        ir = outputs['reverb_ir']
        return self.weight * torch.sum(self.magnitude_order(ir)) / ir.shape[0]
