"""Filtered-noise synthesizers.

Counterpart of ddsp_piano_tpu/processors/noise.py: FilteredNoise and
DynamicSizeFilteredNoise (:64-113), FilterBank (:116-192),
get_noise_bands (:195-212) and NoiseBandNetSynth (:215-302). The uniform
noise is drawn from an explicit torch.Generator on the tensor's device, or
injected by the caller (tests feed the JAX package's own draw: torch
cannot reproduce threefry); so is NoiseBandNetSynth's loop shift, which
the JAX synth draws with jax.random.randint.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ddsp_piano_torch.ops import core, filters
from ddsp_piano_torch.parallel import mesh
from ddsp_piano_torch.processors.base import Processor


def uniform_noise(shape, generator, device) -> torch.Tensor:
    """The (rows, n_samples) uniform draw in [-1, 1) from ``generator``.
    From a parallel.mesh.RankDraw: this rank's rows of the draw a single
    process makes for the global batch."""
    rank_draw = isinstance(generator, mesh.RankDraw)
    rows = shape[0] * mesh.world_size() if rank_draw else shape[0]
    draw = 2.0 * torch.rand(
        (rows, shape[1]),
        generator=generator.generator if rank_draw else generator,
        device=device, dtype=torch.float32) - 1.0
    return mesh.take_rows(draw, generator.global_batch) if rank_draw \
        else draw


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


class FilterBank:
    """Linear then logarithmic bands of Kaiser-window FIR filters, built on
    the host with scipy (noise.py:116-192), plus a low-pass below the
    first band and a high-pass above the last. ``linear_max_f_cutoff_fs
    == 1`` covers the spectrum linearly (the JAX package's repair of the
    reference's undefined variable there)."""

    def __init__(self, n_filters_linear: int = 1024, n_filters_log: int = 1024,
                 linear_min_f: float = 20.0,
                 linear_max_f_cutoff_fs: float = 4.0,
                 attenuation: float = 50.0, sample_rate: int = 16000):
        from scipy import signal as sps

        bands = self._frequency_bands(n_filters_linear, n_filters_log,
                                      linear_min_f, linear_max_f_cutoff_fs,
                                      sample_rate)
        self.band_centers = self._band_centers(bands, sample_rate)
        self.filters = self._build(bands, sample_rate, attenuation, sps)
        self.max_filter_len = max(len(f) for f in self.filters)

    @staticmethod
    def _frequency_bands(n_lin, n_log, linear_min_f, cutoff_fs, sample_rate):
        linear_max_f = (sample_rate / 2) / cutoff_fs
        edges = np.linspace(linear_min_f, linear_max_f, n_lin)
        linear = np.stack([edges[:-1], edges[1:]], axis=1)
        if cutoff_fs == 1:
            return linear
        edges = np.geomspace(linear_max_f, sample_rate / 2, n_log,
                             endpoint=False)
        return np.concatenate([linear,
                               np.stack([edges[:-1], edges[1:]], axis=1)])

    @staticmethod
    def _band_centers(bands, sample_rate):
        lower = bands[0, 0] / 2
        upper = (sample_rate / 2 + bands[-1, -1]) / 2
        return np.concatenate([[lower], bands.mean(axis=1), [upper]])

    @staticmethod
    def _fir(cutoff, sample_rate, attenuation, pass_zero, sps,
             transition_bandwidth=0.2):
        if isinstance(cutoff, np.ndarray):
            bandwidth = abs(cutoff[1] - cutoff[0])
        elif pass_zero:
            bandwidth = cutoff
        else:
            bandwidth = abs(sample_rate / 2 - cutoff)
        width = bandwidth / (sample_rate / 2) * transition_bandwidth
        numtaps, beta = sps.kaiserord(ripple=attenuation, width=width)
        numtaps = 2 * (numtaps // 2) + 1
        return sps.firwin(numtaps=numtaps, cutoff=cutoff,
                          window=('kaiser', beta), scale=True,
                          fs=sample_rate, pass_zero=pass_zero)

    def _build(self, bands, sample_rate, attenuation, sps):
        out = []
        for i in range(bands.shape[0]):
            if i == 0:
                out.append(self._fir(bands[i, 0], sample_rate, attenuation,
                                     True, sps))
            out.append(self._fir(bands[i], sample_rate, attenuation, False,
                                 sps))
            if i == bands.shape[0] - 1:
                out.append(self._fir(bands[i, -1], sample_rate, attenuation,
                                     False, sps))
        return out


def get_noise_bands(fb: FilterBank, min_noise_len: int, normalize: bool,
                    seed: int = 42):
    """Loopable random-phase noise bands, (1, noise_len, n_bands) float32,
    and noise_len: each filter's magnitude response with phases from
    numpy's RandomState(seed), as noise.py:195-212 (bit-equal)."""
    noise_len = (2 ** math.ceil(math.log2(max(fb.max_filter_len, 1)))
                 if fb.max_filter_len > min_noise_len else min_noise_len)
    filt = np.zeros((len(fb.filters), noise_len))
    for i, h in enumerate(fb.filters):
        filt[i, noise_len - len(h):] = h
    mags = np.abs(np.fft.rfft(filt, axis=-1))
    phase = np.random.RandomState(seed).uniform(-math.pi, math.pi,
                                                mags.shape)
    phase[:, 0] = 0.0
    phase[:, -1] = 0.0
    bands = np.fft.irfft(mags * np.exp(1j * phase), axis=-1)
    if normalize:
        bands = bands / np.abs(bands).max()
    return bands.T[np.newaxis].astype(np.float32), noise_len


class NoiseBandNetSynth(Processor):
    """Looped noise bands times upsampled amplitudes (NoiseBandNet).

    The bands loop from a random shift: ``noise=`` injects it as an
    integer in [0, noise_len) for the whole batch, as the JAX synth draws
    one; or as the (b, n_samples) uniform draw in [-1, 1) that the other
    noise synths take, and then each row loops from its own shift, picked
    by the row's first value (the evaluation's per-segment draw, as JAX's
    vmapped evaluation gives each segment its own); with neither, one
    shift is drawn from ``generator``. The amplitudes
    are resampled (linear) per chunk of noise_len // upsampling frames,
    the chunks folded into the batch for one call, with the reference's
    quirks that noise.py:260-302 keeps: the remainder chunk is stretched
    to a whole chunk before the final truncation, and a sequence shorter
    than one chunk (or a noise loop shorter than one frame) is resampled
    as a whole against the looped noise."""

    draws_noise = True

    def __init__(self, n_band: int = 64, upsampling: int = 64,
                 filterbank_attenuation: float = 50.0,
                 sample_rate: int = 16000, min_noise_len: int = 2 ** 4,
                 linear_min_f: float = 20.0,
                 linear_max_f_cutoff_fs: float = 4.0,
                 normalize_noise_bands: bool = True,
                 scale_fn: Optional[Callable] = core.exp_sigmoid,
                 inference: bool = False, name: str = 'noise'):
        super().__init__(name=name)
        if (min_noise_len <= 0
                or 2 ** int(math.log2(min_noise_len)) != min_noise_len):
            raise ValueError("min_noise_len must be a positive power of 2")
        self.scale_fn = scale_fn
        self.upsampling = upsampling
        self.sample_rate = sample_rate
        # Read by neither the reference nor the JAX synth.
        self.inference = inference
        fb = FilterBank(n_filters_linear=n_band // 2,
                        n_filters_log=n_band // 2,
                        linear_min_f=linear_min_f,
                        linear_max_f_cutoff_fs=linear_max_f_cutoff_fs,
                        sample_rate=sample_rate,
                        attenuation=filterbank_attenuation)
        self.center_frequencies = fb.band_centers
        bands, self.noise_len = get_noise_bands(fb, min_noise_len,
                                                normalize_noise_bands)
        # Made at construction: not a parameter, not in a checkpoint.
        self.register_buffer('noise_bands', torch.from_numpy(bands),
                             persistent=False)

    def get_controls(self, magnitudes):
        if self.scale_fn is not None:
            magnitudes = self.scale_fn(magnitudes)
        return {'amplitudes': core.f32(magnitudes)}

    def _shift(self, noise, generator, rows: int, n_samples: int,
               device) -> torch.Tensor:
        """The loop shift: () for one over the batch, (rows,) for one a
        row."""
        length = self.noise_bands.shape[1]
        if noise is None:
            if isinstance(generator, mesh.RankDraw):
                generator = generator.generator    # one shift for all rows
            return torch.randint(0, length, (), generator=generator,
                                 device=device)
        noise = torch.as_tensor(noise, device=device)
        if noise.dim() == 0 and not noise.is_floating_point():
            return noise.long()
        if noise.is_floating_point() and tuple(noise.shape) == (rows,
                                                                n_samples):
            picked = torch.floor((noise[:, 0].double() + 1.0) / 2.0 * length)
            return torch.clamp(picked.long(), 0, length - 1)
        raise ValueError(
            "NoiseBandNetSynth's noise= is an integer loop shift or a "
            f"({rows}, {n_samples}) uniform draw, got "
            f"{noise.dtype} of shape {tuple(noise.shape)}")

    def get_signal(self, amplitudes, noise=None,
                   generator: Optional[torch.Generator] = None):
        """amplitudes (b, n_frames, n_bands) -> (b, n_frames * up)."""
        b, n_frames, n_bands = amplitudes.shape
        n_samples = n_frames * self.upsampling
        length = self.noise_bands.shape[1]
        shift = self._shift(noise, generator, b, n_samples, amplitudes.device)
        # jnp.roll(bands, shift, axis=1) as a gather, one row of bands for
        # each shift: no host sync for a shift on the card.
        idx = torch.remainder(torch.arange(length, device=amplitudes.device)
                              - shift.unsqueeze(-1), length)
        bands = self.noise_bands.to(amplitudes.device)[0][
            idx.reshape(-1, length)]

        frame_len = self.noise_len // self.upsampling
        chunk_samples = frame_len * self.upsampling
        if frame_len == 0 or n_frames < frame_len:
            reps = -(-n_samples // self.noise_len)
            looped = bands.repeat(1, reps, 1)[:, :n_samples]
            upsampled = core.resample(amplitudes, n_samples)
            return torch.sum(looped * upsampled, dim=-1)

        n_full = n_frames // frame_len
        main = amplitudes[:, :n_full * frame_len].reshape(
            b * n_full, frame_len, n_bands)
        upsampled = core.resample(main, chunk_samples).reshape(
            b, n_full * chunk_samples, n_bands)
        if n_frames - n_full * frame_len:
            rem = core.resample(amplitudes[:, n_full * frame_len:],
                                chunk_samples)
            upsampled = torch.cat([upsampled, rem], dim=1)
        n_chunks = upsampled.shape[1] // chunk_samples
        looped = bands[:, :chunk_samples].repeat(1, n_chunks, 1)
        return torch.sum(looped * upsampled, dim=-1)[:, :n_samples]
