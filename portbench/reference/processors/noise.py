"""Filtered-noise synthesizers.

Counterpart of ddsp_piano_tpu/processors/noise.py: FilteredNoise and
DynamicSizeFilteredNoise (:64-113). The uniform noise is drawn from an
explicit torch.Generator on the tensor's device, or injected by the
caller (the benchmark hands both sides the same draw).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.reference.ops import core, filters
from portbench.reference.processors.base import Processor


def uniform_noise(shape, generator, device) -> torch.Tensor:
    """The (rows, n_samples) uniform draw in [-1, 1) from ``generator``."""
    return 2.0 * torch.rand(shape, generator=generator, device=device,
                            dtype=torch.float32) - 1.0


class FilteredNoise(Processor):
    """Fixed-length filtered noise (ddsp.synths.FilteredNoise)."""

    draws_noise = True

    def __init__(self, n_samples: int = 64000, window_size: int = 257,
                 scale_fn: Optional[Callable] = core.exp_sigmoid,
                 initial_bias: float = -5.0, name: str = 'filtered_noise'):
        super().__init__(name=name)
        self.n_samples = n_samples
        self.window_size = window_size
        self.scale_fn = scale_fn
        self.initial_bias = initial_bias

    def get_controls(self, magnitudes):
        if self.scale_fn is not None:
            magnitudes = self.scale_fn(magnitudes + self.initial_bias)
        return {'magnitudes': core.f32(magnitudes)}

    def n_samples_for(self, magnitudes) -> int:
        return self.n_samples

    def get_signal(self, magnitudes, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        shape = (magnitudes.shape[0], self.n_samples_for(magnitudes))
        if noise is None:
            noise = uniform_noise(shape, generator, magnitudes.device)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"injected noise must be {shape}, got "
                             f"{tuple(noise.shape)}")
        return filters.frequency_filter(noise.to(magnitudes.device),
                                        magnitudes,
                                        window_size=self.window_size)


class DynamicSizeFilteredNoise(FilteredNoise):
    """Filtered noise of length upsampling * n_frames."""

    def __init__(self, frame_rate: int = 250, sample_rate: int = 16000,
                 name: str = 'noise', **kwargs):
        super().__init__(name=name, **kwargs)
        self.frame_rate = frame_rate
        self.sample_rate = sample_rate

    @property
    def upsampling(self) -> int:
        return int(self.sample_rate / self.frame_rate)

    def n_samples_for(self, magnitudes) -> int:
        return self.upsampling * magnitudes.shape[1]
