"""Feedback-Delay-Network reverb IR by frequency sampling.

Counterpart of ddsp_piano_tpu/ops/fdn.py:54-183, with the batch of
per-instrument parameter sets written out as a leading dimension (the JAX
package vmaps the per-instance function). 8 delay lines with fixed
lengths, the Householder-style mixing matrix M = -I + 0.5 ones, a one-pole
low-pass per line, 4 series allpasses per line and first-order allpass
fractional delays; H(e^jw) is evaluated on the rfft grid of
``freq_points`` points and inverse-rFFT'd to the late IR.

The system matrix per bin is diagonal plus rank one, so Sherman-Morrison
solves it with elementwise complex ops; the dense batched solve
(torch.linalg.solve) is kept as the fallback for other mixing matrices.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ddsp_piano_torch.ops import filters

DEFAULT_DELAY_VALUES = (233.0, 311.0, 421.0, 461.0, 587.0, 613.0, 789.0, 891.0)
DEFAULT_DELAYS_ALLPASS = (
    (131.0, 151.0, 337.0, 353.0),
    (103.0, 173.0, 331.0, 373.0),
    (89.0, 181.0, 307.0, 401.0),
    (79.0, 197.0, 281.0, 419.0),
    (61.0, 211.0, 257.0, 431.0),
    (47.0, 229.0, 251.0, 443.0),
    (81.0, 189.0, 287.0, 407.0),
    (91.0, 203.0, 321.0, 377.0),
)


class FDNParams(NamedTuple):
    """A batch of FDN controls (leading dimension b)."""
    input_gain: torch.Tensor      # (b, n_lines)
    output_gain: torch.Tensor     # (b, n_lines)
    gain_allpass: torch.Tensor    # (b, n_lines, n_allpass)
    delays_allpass: torch.Tensor  # (b, n_lines, n_allpass)
    time_rev_0_sec: torch.Tensor  # (b,) or (b, 1): T60 at DC (s)
    alpha_tone: torch.Tensor      # (b,) or (b, 1) in (0, 1)
    early_ir: torch.Tensor        # (b, early_ir_length)


def householder_mixing_matrix(n: int, device=None) -> torch.Tensor:
    return (-torch.eye(n, dtype=torch.float32, device=device)
            + 0.5 * torch.ones((n, n), dtype=torch.float32, device=device))


def _c64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.complex64)


def _decay(delay_sec: torch.Tensor, t60: torch.Tensor) -> torch.Tensor:
    """10^(-3 delay / T60), evaluated in float64 and rounded once to the
    inputs' type. The float32 power of the CPU differs in the last place
    between its vectorized loop and the scalar tail, so a row's value
    would depend on the batch it is in (and a rank's rows would not be the
    global batch's); rounded once it is the same in any batch, and on any
    device."""
    return (10.0 ** (-3.0 * delay_sec.double() / t60.double())).to(
        delay_sec.dtype)


def _prod_last(x: torch.Tensor) -> torch.Tensor:
    """The product over the last axis, multiplied out in order: the
    gradient of torch.prod reads on the host whether a factor is zero, which
    a CUDA graph of the training step cannot capture."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out * x[..., i]
    return out


def fdn_late_ir(params: FDNParams, sample_rate: float,
                delay_values: Optional[torch.Tensor] = None,
                freq_points: Optional[int] = None,
                use_householder_closed_form: bool = True) -> torch.Tensor:
    """(b, freq_points) late-reverb IRs (default 2 * sample_rate long)."""
    dev = params.input_gain.device
    if delay_values is None:
        delay_values = torch.tensor(DEFAULT_DELAY_VALUES, device=dev)
    delay_values = delay_values.to(device=dev, dtype=torch.float32)
    n_lines = delay_values.shape[0]
    if freq_points is None:
        freq_points = int(2 * sample_rate)
    n_bins = freq_points // 2 + 1

    wk = (2.0 * math.pi / freq_points) * torch.arange(
        n_bins, dtype=torch.float32, device=dev)
    iwk = torch.complex(torch.zeros_like(wk), wk)             # (bins,)
    z_inv = torch.exp(-iwk)

    z_d = torch.exp(-iwk[:, None] * _c64(torch.floor(delay_values))[None, :])
    d_eta = _c64(delay_values - torch.floor(delay_values))
    eta = (1.0 - d_eta) / (1.0 + d_eta)                        # (lines,)
    allpass_interp = ((eta[None, :] + z_inv[:, None])
                      / (1.0 + eta[None, :] * z_inv[:, None]))
    delay_diag = z_d * allpass_interp                          # (bins, lines)

    b = params.input_gain.shape[0]
    t60 = params.time_rev_0_sec.reshape(b, 1)
    alpha = params.alpha_tone.reshape(b, 1)
    delay_sec = (delay_values[None, :]
                 + torch.sum(params.delays_allpass, dim=-1)) / sample_rate
    k = _decay(delay_sec, t60)                                 # (b, lines)
    kpi = _decay(delay_sec, alpha * t60)
    g = _c64(2.0 * k * kpi / (k + kpi))
    p = _c64((k - kpi) / (k + kpi))
    lp = g[:, None, :] / (1.0 - p[:, None, :] * z_inv[None, :, None]
                          + 1e-8)                              # (b, bins, L)

    ga = _c64(params.gain_allpass)[:, None]                    # (b,1,L,ap)
    da = _c64(params.delays_allpass)[:, None]
    z_ap = torch.exp(iwk[None, :, None, None] * da)            # (b,bins,L,ap)
    ap = _prod_last((1.0 + ga * z_ap) / (ga + z_ap))           # (b,bins,L)

    g_in = _c64(params.input_gain)[:, None, :]                 # (b, 1, L)
    g_out = _c64(params.output_gain)[:, None, :]

    if use_householder_closed_form:
        c1 = lp
        c2 = ap * delay_diag[None]
        d_prime = 1.0 + c1 * c2
        g_over = g_in / d_prime
        u_over = c1 / d_prime
        vg = torch.sum(c2 * g_over, dim=-1, keepdim=True)
        vu = torch.sum(c2 * u_over, dim=-1, keepdim=True)
        x = g_over + 0.5 * u_over * vg / (1.0 - 0.5 * vu)
    else:
        mixing = _c64(householder_mixing_matrix(n_lines, dev))
        feedback = (lp[..., :, None] * mixing) * ap[..., None, :]
        eye = torch.eye(n_lines, dtype=torch.complex64, device=dev)
        system = eye - feedback * delay_diag[None, :, None, :]
        rhs = g_in.expand(b, n_bins, n_lines)[..., None]
        x = torch.linalg.solve(system, rhs)[..., 0]

    h = torch.sum(g_out * delay_diag[None] * x, dim=-1)        # (b, bins)
    return torch.fft.irfft(h, n=freq_points, dim=-1).to(torch.float32)


def fdn_ir(params: FDNParams, sample_rate: float,
           delay_values: Optional[torch.Tensor] = None,
           freq_points: Optional[int] = None) -> torch.Tensor:
    """(b, freq_points) IRs: late FDN tail plus the zero-padded early FIR."""
    late = fdn_late_ir(params, sample_rate, delay_values, freq_points)
    early = params.early_ir.reshape(late.shape[0], -1)
    n = late.shape[-1]
    if early.shape[-1] < n:
        early = torch.nn.functional.pad(early, (0, n - early.shape[-1]))
    return early[:, :n] + late


def fdn_reverb_signal(audio: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """The FDN IR applied by FFT convolution, with no dry mask and no dry
    add (fdn.py:175-183)."""
    if ir.dim() == 1:
        ir = ir[None, :]
    return filters.fft_convolve(audio, ir, padding='same',
                                delay_compensation=0)
