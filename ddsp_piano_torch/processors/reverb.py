"""Reverb processors: convolution reverb with a supplied IR, and the FDN IR.

Counterpart of ddsp_piano_tpu/processors/reverb.py: Reverb (dry-tap mask
plus dry add, :27-64) and FeedbackDelayNetwork (:67-160): its get_ir for
the v2 model, whose FDN controls come from per-instrument embeddings, and
its trainable mode, the ENSTDkCl models' standalone reverb.
"""

from __future__ import annotations

import torch

from ddsp_piano_torch.ops import core, fdn, filters
from ddsp_piano_torch.processors.base import Processor


class Reverb(Processor):
    """Convolution reverb with an externally supplied IR, or with its own
    trainable IR of ``reverb_length`` samples (reverb.py:27-64)."""

    def __init__(self, trainable: bool = False, reverb_length: int = 48000,
                 add_dry: bool = True, name: str = 'reverb'):
        super().__init__(name=name)
        self.trainable = trainable
        self.reverb_length = reverb_length
        self.add_dry = add_dry
        if trainable:
            self.ir = torch.nn.Parameter(torch.zeros(reverb_length))

    def reset_parameters(self, generator: torch.Generator):
        """The JAX init: 1e-6 times a standard normal."""
        if self.trainable:
            with torch.no_grad():
                self.ir.copy_(1e-6 * torch.randn(self.ir.shape,
                                                 generator=generator))

    @staticmethod
    def mask_dry_ir(ir: torch.Tensor) -> torch.Tensor:
        if ir.dim() == 1:
            ir = ir[None, :]
        elif ir.dim() == 3:
            ir = ir[:, :, 0]
        return torch.cat([ir.new_zeros((ir.shape[0], 1)), ir[:, 1:]], dim=1)

    def get_controls(self, audio, ir=None):
        if self.trainable:
            ir = self.ir
        if ir is None:
            raise ValueError("Reverb requires an 'ir' control when not "
                             "trainable.")
        return {'audio': audio, 'ir': core.f32(ir)}

    def get_signal(self, audio, ir):
        wet = filters.fft_convolve(core.f32(audio), self.mask_dry_ir(ir),
                                   padding='same', delay_compensation=0)
        return (wet + audio) if self.add_dry else wet


class FeedbackDelayNetwork(Processor):
    """FDN reverb. With supplied controls (the v2 model's per-instrument
    embeddings) it only synthesises IRs (:meth:`get_ir`). ``trainable``
    (the ENSTDkCl models' standalone reverb) holds the controls as its own
    parameters, mapped to controls as reverb.py:113-123 maps them, and
    reverberates the dry mix with its IR; ``delay_trainable`` makes the
    delay-line lengths parameters too (else the fixed lengths, a buffer).
    Its parameters sit under the group's ``DelayNetwork``, the JAX
    processor's name."""

    def __init__(self, trainable: bool = False,
                 sampling_rate: float = 16000.0, delay_lines: int = 8,
                 early_ir_length: int = 200, delay_trainable: bool = False,
                 name: str = 'DelayNetwork'):
        super().__init__(name=name)
        self.trainable = trainable
        self.delay_trainable = delay_trainable and trainable
        self.sampling_rate = float(sampling_rate)
        self.delay_lines = delay_lines
        self.early_ir_length = early_ir_length
        if self.delay_trainable:
            self.delay_values = torch.nn.Parameter(torch.zeros(delay_lines))
        else:
            self.register_buffer('delay_values', torch.tensor(
                fdn.DEFAULT_DELAY_VALUES[:delay_lines],
                dtype=torch.float32), persistent=False)
        if trainable:
            for name, shape in self._param_shapes():
                setattr(self, name, torch.nn.Parameter(torch.zeros(shape)))

    def _param_shapes(self):
        n = self.delay_lines
        return (('early_ir', (self.early_ir_length,)), ('input_gain', (n,)),
                ('output_gain', (n,)), ('time_rev_0_sec', ()),
                ('alpha_tone', ()), ('delays_allpass', (n, 4)),
                ('gain_allpass', (n, 4)))

    # (mean, stddev) of each trainable parameter's normal init
    # (reverb.py:97-111).
    _INIT = {'early_ir': (0.0, 0.1), 'input_gain': (0.25, 0.1),
             'output_gain': (0.25, 0.1), 'time_rev_0_sec': (2.0, 0.5),
             'alpha_tone': (0.0, 0.1), 'delays_allpass': (400.0, 60.0),
             'gain_allpass': (0.25, 0.1), 'delay_values': (400.0, 60.0)}

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            for name, p in self.named_parameters(recurse=False):
                mean, std = self._INIT[name]
                p.copy_(mean + std * torch.randn(p.shape,
                                                 generator=generator))

    @property
    def freq_points(self) -> int:
        return int(2 * self.sampling_rate)

    def get_ir(self, input_gain, output_gain, gain_allpass, delays_allpass,
               time_rev_0_sec, alpha_tone, early_ir) -> torch.Tensor:
        controls = fdn.FDNParams(input_gain, output_gain, gain_allpass,
                                 delays_allpass, time_rev_0_sec, alpha_tone,
                                 early_ir)
        return fdn.fdn_ir(controls, self.sampling_rate,
                          delay_values=self.delay_values,
                          freq_points=self.freq_points)

    def trained_ir(self) -> torch.Tensor:
        """(1, freq_points): the IR of the processor's own parameters."""
        if not self.trainable:
            raise ValueError("This FeedbackDelayNetwork holds no parameters: "
                             "its controls come from the reverb model "
                             "(get_ir).")
        return self.get_ir(
            input_gain=self.input_gain[None],
            output_gain=self.output_gain[None],
            gain_allpass=self.gain_allpass[None],
            delays_allpass=self.delays_allpass[None],
            time_rev_0_sec=core.maximum(self.time_rev_0_sec, 0.0)[None],
            alpha_tone=torch.sigmoid(self.alpha_tone)[None],
            early_ir=self.early_ir[None])

    def get_controls(self, audio):
        return {'audio': audio, 'ir': self.trained_ir()}

    def get_signal(self, audio, ir):
        return fdn.fdn_reverb_signal(core.f32(audio), ir)
