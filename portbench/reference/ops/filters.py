"""FIR filtering: frequency-sampled time-varying filters and FFT
convolution.

Counterpart of ddsp_piano_tpu/ops/filters.py (overlap_and_add,
crop_and_compensate_delay, get_fft_size, fft_convolve,
apply_window_to_impulse_response, frequency_impulse_response and
frequency_filter with its linmap, fft and conv methods). The host
constants of the linmap path are the same float64 numpy computations
rounded to float32; its einsums are matmuls.

One difference of schedule, not of result: a single long IR (fft size
>= 32768) is convolved with one cuFFT transform pair here, where the JAX
package partitions it into 4096-sample blocks (a TPU FFT schedule,
filters.py:89-131). Both compute the same linear convolution and crop it
the same way, including the zero-padding of a crop window that runs past
the convolution (filters.py:119-129).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from portbench.reference.ops import core

_PARTITIONED_MIN_FFT = 32768


def get_fft_size(frame_size: int, ir_size: int,
                 power_of_2: bool = True) -> int:
    """Smallest FFT length holding the linear convolution of the two."""
    conv_size = frame_size + ir_size - 1
    if power_of_2:
        return int(2 ** math.ceil(math.log2(conv_size)))
    return conv_size


def overlap_and_add(frames: torch.Tensor, frame_step: int) -> torch.Tensor:
    """(..., n_frames, frame_length) -> (..., output_len), as
    tf.signal.overlap_and_add: segments summed on their diagonals."""
    *batch, n_frames, frame_length = frames.shape
    out_len = frame_step * (n_frames - 1) + frame_length
    if frame_length % frame_step != 0:
        pad = frame_step - frame_length % frame_step
        frames = torch.nn.functional.pad(frames, (0, pad))
        frame_length += pad
    segments = frame_length // frame_step
    x = frames.reshape(*batch, n_frames, segments, frame_step)
    out_frames = n_frames + segments - 1
    out = frames.new_zeros((*batch, out_frames, frame_step))
    for s in range(segments):
        out[..., s:s + n_frames, :] += x[..., :, s, :]
    return out.reshape(*batch, out_frames * frame_step)[..., :out_len]


def crop_and_compensate_delay(audio: torch.Tensor, audio_size: int,
                              ir_size: int, padding: str = 'same',
                              delay_compensation: int = -1) -> torch.Tensor:
    """Crop convolution output and compensate filter group delay."""
    if padding == 'valid':
        crop_size = ir_size + audio_size - 1
    elif padding == 'same':
        crop_size = audio_size
    else:
        raise ValueError(f"padding must be 'valid' or 'same', got {padding!r}")
    start = ((ir_size - 1) // 2 - 1 if delay_compensation < 0
             else delay_compensation)
    return audio[..., start:start + crop_size]


def _fft_convolve_single(audio: torch.Tensor, ir: torch.Tensor,
                         padding: str, delay_compensation: int):
    """One long IR per batch row (or one broadcast IR): one rfft/irfft
    pair of the whole signal, cropped as the JAX partitioned path crops."""
    n = audio.shape[-1]
    ir_size = ir.shape[-1]
    fft_size = get_fft_size(n, ir_size)
    spec = (torch.fft.rfft(audio, n=fft_size, dim=-1)
            * torch.fft.rfft(ir, n=fft_size, dim=-1))
    out = torch.fft.irfft(spec, n=fft_size, dim=-1)
    crop_size = n + ir_size - 1 if padding == 'valid' else n
    start = ((ir_size - 1) // 2 - 1 if delay_compensation < 0
             else delay_compensation)
    need = start + crop_size
    if out.shape[-1] < need:
        out = torch.nn.functional.pad(out, (0, need - out.shape[-1]))
    return crop_and_compensate_delay(out, n, ir_size, padding,
                                     delay_compensation)


def fft_convolve(audio: torch.Tensor, impulse_response: torch.Tensor,
                 padding: str = 'same',
                 delay_compensation: int = -1) -> torch.Tensor:
    """FIR filtering of (batch, n) audio by FFT block convolution.

    impulse_response: (batch or 1, ir_size) for one IR, or
    (batch or 1, n_frames, ir_size) for a time-varying filter (the audio is
    cut into n_frames equal blocks, each convolved with its IR and
    overlap-added).
    """
    audio = core.f32(audio)
    impulse_response = core.f32(impulse_response)
    batch_size, audio_size = audio.shape
    if impulse_response.shape[0] not in (batch_size, 1):
        raise ValueError(
            f"Batch size of impulse response ({impulse_response.shape[0]}) "
            f"must match audio ({batch_size}) or be 1.")
    if impulse_response.dim() == 2:
        if (get_fft_size(audio_size, impulse_response.shape[-1])
                >= _PARTITIONED_MIN_FFT):
            return _fft_convolve_single(audio, impulse_response, padding,
                                        delay_compensation)
        impulse_response = impulse_response[:, None, :]
    _, n_ir_frames, ir_size = impulse_response.shape
    frame_size = -(-audio_size // n_ir_frames)
    pad = n_ir_frames * frame_size - audio_size
    audio_frames = torch.nn.functional.pad(audio, (0, pad)).reshape(
        batch_size, n_ir_frames, frame_size)
    fft_size = get_fft_size(frame_size, ir_size, power_of_2=True)
    audio_fft = torch.fft.rfft(audio_frames, n=fft_size, dim=-1)
    ir_fft = torch.fft.rfft(impulse_response, n=fft_size, dim=-1)
    frames_out = torch.fft.irfft(audio_fft * ir_fft, n=fft_size, dim=-1)
    audio_out = overlap_and_add(frames_out, frame_size)
    return crop_and_compensate_delay(audio_out, audio_size, ir_size, padding,
                                     delay_compensation)


@functools.lru_cache(maxsize=None)
def np_ir_basis(n_bands: int, window_size: int) -> np.ndarray:
    """frequency_impulse_response(eye(n_bands)) as a float32 host constant,
    computed in float64."""
    ir = torch.fft.irfft(torch.eye(n_bands, dtype=torch.complex128), dim=-1)
    return _window_and_shift(ir, window_size).float().numpy()


@functools.lru_cache(maxsize=None)
def _ir_basis_device(n_bands: int, window_size: int, device: torch.device):
    """np_ir_basis copied to ``device`` once, outside inference mode (as
    _linmap_device_constants)."""
    with torch.inference_mode(False):
        return torch.from_numpy(np_ir_basis(n_bands, window_size)).to(device)


@functools.lru_cache(maxsize=None)
def _linmap_mm_constants(frame_size: int, n_bands: int, window_size: int,
                         fft_size: int):
    """float32 host matrices (w2, b2, inv2) of the all-matmul branch: the
    frames' DFT, the basis-IR spectra and the inverse DFT restricted to the
    conv_size supported outputs, real and imaginary parts side by side."""
    basis = np_ir_basis(n_bands, window_size).astype(np.float64)
    ir_size = basis.shape[-1]
    conv_size = frame_size + ir_size - 1
    n_freqs = fft_size // 2 + 1
    bf = np.fft.rfft(basis, n=fft_size, axis=-1)
    w = np.fft.rfft(np.eye(frame_size), n=fft_size, axis=-1)
    w2 = np.concatenate([w.real, w.imag], axis=1).astype(np.float32)
    b2 = np.concatenate([bf.real, bf.imag], axis=1).astype(np.float32)
    inv = np.fft.irfft(np.eye(n_freqs, dtype=np.complex128),
                       n=fft_size, axis=-1)[:, :conv_size]
    inv_im = np.fft.irfft(1j * np.eye(n_freqs, dtype=np.complex128),
                          n=fft_size, axis=-1)[:, :conv_size]
    inv2 = np.concatenate([inv, inv_im], axis=0).astype(np.float32)
    return w2, b2, inv2


@functools.lru_cache(maxsize=None)
def _linmap_device_constants(frame_size: int, n_bands: int, window_size: int,
                             fft_size: int, use_mm: bool,
                             device: torch.device):
    """The linmap path's float32 constants, copied to ``device`` once: a
    copy from pageable host memory synchronises the stream. They are made
    outside inference mode, so that a render under inference_mode does not
    leave tensors that a later training step cannot save for backward."""
    with torch.inference_mode(False):
        return _linmap_constants_on(frame_size, n_bands, window_size,
                                    fft_size, use_mm, device)


def _linmap_constants_on(frame_size, n_bands, window_size, fft_size, use_mm,
                         device):
    if use_mm:
        mats = _linmap_mm_constants(frame_size, n_bands, window_size,
                                    fft_size)
    else:
        basis = np_ir_basis(n_bands, window_size).astype(np.float64)
        basis_fft = np.fft.rfft(basis, n=fft_size, axis=-1)
        mats = (basis_fft.real.astype(np.float32),
                basis_fft.imag.astype(np.float32))
    return tuple(torch.from_numpy(m).to(device) for m in mats)


def _frequency_filter_linmap(audio: torch.Tensor, magnitudes: torch.Tensor,
                             window_size: int, padding: str) -> torch.Tensor:
    """Framed time-varying filtering with the IR spectra as one matmul of
    the magnitudes by a fixed basis (filters.py:380-451)."""
    batch, n = audio.shape
    _, n_frames, n_bands = magnitudes.shape
    frame_size = -(-n // n_frames)
    basis = np_ir_basis(n_bands, window_size)
    ir_size = basis.shape[-1]
    fft_pow2 = get_fft_size(frame_size, ir_size, power_of_2=True)
    conv_size = frame_size + ir_size - 1
    use_mm = frame_size * 4 <= fft_pow2 * 3
    fft_size = conv_size if use_mm else fft_pow2
    mags = core.f32(magnitudes)
    dev = audio.device

    pad = n_frames * frame_size - n
    audio_frames = torch.nn.functional.pad(audio, (0, pad)).reshape(
        batch, n_frames, frame_size)

    constants = _linmap_device_constants(frame_size, n_bands, window_size,
                                         fft_size, use_mm, dev)
    if use_mm:
        w2, b2, inv2 = constants
        a2 = torch.matmul(audio_frames, w2)
        i2 = torch.matmul(mags, b2)
        n_freqs = fft_size // 2 + 1
        a_re, a_im = a2[..., :n_freqs], a2[..., n_freqs:]
        ir_re, ir_im = i2[..., :n_freqs], i2[..., n_freqs:]
        p2 = torch.cat([a_re * ir_re - a_im * ir_im,
                        a_re * ir_im + a_im * ir_re], dim=-1)
        out_frames = torch.matmul(p2, inv2)
    else:
        b_re, b_im = constants
        ir_fft = torch.complex(torch.matmul(mags, b_re),
                               torch.matmul(mags, b_im))
        audio_fft = torch.fft.rfft(audio_frames, n=fft_size, dim=-1)
        out_frames = torch.fft.irfft(audio_fft * ir_fft, n=fft_size,
                                     dim=-1)[..., :conv_size]
    out = overlap_and_add(out_frames, frame_size)
    return crop_and_compensate_delay(out, n, ir_size, padding, -1)


def _window_and_shift(impulse_response: torch.Tensor,
                      window_size: int) -> torch.Tensor:
    """Hann-window a zero-phase IR and shift it causal, in its dtype."""
    ir_size = impulse_response.shape[-1]
    if window_size <= 0 or window_size > ir_size:
        window_size = ir_size
    window = core.hann_window(window_size, periodic=True,
                              device=impulse_response.device,
                              dtype=impulse_response.dtype)
    padding = ir_size - window_size
    if padding > 0:
        half_idx = (window_size + 1) // 2
        window = torch.cat([window[half_idx:], window.new_zeros(padding),
                            window[:half_idx]])
    else:
        window = torch.fft.fftshift(window, dim=-1)
    impulse_response = window * impulse_response
    if padding > 0:
        first_half_start = (ir_size - (half_idx - 1)) + 1
        second_half_end = half_idx + 1
        return torch.cat([impulse_response[..., first_half_start:],
                          impulse_response[..., :second_half_end]], dim=-1)
    return torch.fft.fftshift(impulse_response, dim=-1)


def apply_window_to_impulse_response(impulse_response: torch.Tensor,
                                     window_size: int = 0,
                                     causal: bool = False) -> torch.Tensor:
    """Hann-window a zero-phase IR and return it causal (filters.py:
    182-211)."""
    impulse_response = core.f32(impulse_response)
    if causal:
        impulse_response = torch.fft.fftshift(impulse_response, dim=-1)
    return _window_and_shift(impulse_response, window_size)


def frequency_impulse_response(magnitudes: torch.Tensor,
                               window_size: int = 0) -> torch.Tensor:
    """Linear-phase FIR from band magnitudes (zero phase): irfft, then the
    Hann window and the causal shift (filters.py:214-219)."""
    impulse_response = torch.fft.irfft(
        core.f32(magnitudes).to(torch.complex64), dim=-1)
    return apply_window_to_impulse_response(impulse_response,
                                            window_size=window_size)


def _frequency_filter_conv(audio: torch.Tensor, magnitudes: torch.Tensor,
                           window_size: int, padding: str) -> torch.Tensor:
    """Time-varying filtering as one convolution (filters.py:222-251): the
    block convolution weights every input sample by its frame's
    magnitudes, so with u_k = audio * (magnitudes[:, frame, k] held over
    the frame) the output is sum_k u_k * basis_k, the basis IRs being
    frequency_impulse_response of the identity (np_ir_basis)."""
    n = audio.shape[-1]
    n_frames, n_bands = magnitudes.shape[1:]
    hop = n // n_frames
    basis = _ir_basis_device(n_bands, window_size, audio.device)
    ir_size = basis.shape[-1]
    held = torch.repeat_interleave(core.f32(magnitudes).transpose(1, 2), hop,
                                   dim=-1)                     # (b, K, n)
    u = audio[:, None, :] * held
    # conv1d correlates: flip the kernel for a convolution.
    kernel = torch.flip(basis, dims=(-1,))[None]               # (1, K, ir)
    out = torch.nn.functional.conv1d(u, kernel, padding=ir_size - 1)[:, 0]
    return crop_and_compensate_delay(out, n, ir_size, padding, -1)


METHODS = ('auto', 'fft', 'conv', 'linmap')


def frequency_filter(audio: torch.Tensor, magnitudes: torch.Tensor,
                     window_size: int = 0, padding: str = 'same',
                     method: str = 'auto') -> torch.Tensor:
    """Time-varying FIR filtering from frame-rate band magnitudes
    (batch, n_frames, n_bands), as filters.py:454-486: 'auto' and
    'linmap' take the linmap path for framed magnitudes; 'conv' the one
    convolution (when the audio is a whole number of frames); the rest
    the block-FFT chain, frequency_impulse_response then fft_convolve."""
    audio = core.f32(audio)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    framed = magnitudes.dim() == 3 and magnitudes.shape[1] > 1
    if (method == 'conv' and framed
            and audio.shape[-1] % magnitudes.shape[1] == 0):
        return _frequency_filter_conv(audio, magnitudes, window_size,
                                      padding)
    if method in ('auto', 'linmap') and framed:
        return _frequency_filter_linmap(audio, magnitudes, window_size,
                                        padding)
    impulse_response = frequency_impulse_response(magnitudes, window_size)
    return fft_convolve(audio, impulse_response, padding=padding,
                        delay_compensation=-1)
