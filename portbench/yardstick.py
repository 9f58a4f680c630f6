"""The yardstick: published peaks, the kernels' least times and the model's
operation count.

The operation and byte counts of the kernels are a copy of chip_smoke.py's
(its ``bound``, ``gru_bound``, ``gru_bwd_bound``, ``osc_bound`` /
``OSC_FLOPS_PER_TERM`` and ``osc_bwd_bound``), kept
here so that a change to the program cannot move the yardstick. The counts
are taken from the kernels' inner loops (csrc/*.cu); a kernel's least time
is the larger of its operations over the float32 peak and its bytes over
the memory bandwidth, each input read once and each output written once.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores and
# HBM3 bandwidth, both at the 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Operations per unit of work, from the kernels' loops.
OSC_FLOPS_PER_TERM = 34         # K1, per live (partial, sample): phase 6,
#   crossfade 3, frequency 2, mask 1, range reduction 8, polynomial 12,
#   multiply-accumulate 2
OSC_BWD_FLOPS_SOUNDING = 50     # K4, per (partial, sample) of a sounding
#   cell below Nyquist
OSC_BWD_FLOPS_SILENT = 30       # K4, per (partial, sample) of a silent cell
#   below Nyquist
GRU_GATE_FLOPS_PER_UNIT = 17    # K2, per (step, row, unit), besides h U + b
GRU_BWD_GATE_FLOPS_PER_UNIT = 34  # K5, per (step, row, unit), besides the
#   recomputed h U + b and the chain's three U^T products


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time on the published peaks: the larger of operations
    over the float32 rate and bytes over the bandwidth."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def gru_seconds(t: int, b: int, u: int) -> float:
    """K2 at (T, B, u): h U + b and the gates a (step, row); x_proj read,
    hs written, the weights read once."""
    three_u = 3 * u
    flops = t * b * (2 * u * three_u + three_u + GRU_GATE_FLOPS_PER_UNIT * u)
    nbytes = 4 * (t * b * three_u + t * b * u + u * three_u + three_u
                  + b * u)
    return least_seconds(flops, nbytes)


def gru_bwd_seconds(t: int, b: int, u: int) -> float:
    """K5 at (T, B, u): the recomputed h U + b, the chain's three U^T
    products and the gates a (step, row); its inputs read and five streams
    written once."""
    three_u = 3 * u
    flops = t * b * (4 * u * three_u + 2 * three_u
                     + GRU_BWD_GATE_FLOPS_PER_UNIT * u)
    nbytes = 4 * (t * b * three_u + 2 * t * b * u + 2 * u * three_u
                  + three_u + b * u + 4 * t * b * u + b * u)
    return least_seconds(flops, nbytes)


def osc_seconds(b: int, n_frames: int, k: int, up: int, live: int) -> float:
    """K1 at (B, n_frames, K) controls: its operations on the live cells
    (below Nyquist and not silent), against five control reads and one
    audio write."""
    return least_seconds(OSC_FLOPS_PER_TERM * live * up,
                         4 * (5 * b * n_frames * k + b * n_frames * up))


def osc_bwd_seconds(b: int, n_frames: int, k: int, up: int, sounding: int,
                    silent: int) -> float:
    """K4 at (B, n_frames, K) controls: its operations on the sounding and
    silent cells below Nyquist, against its reads (five controls, the
    cotangent) and its writes (five gradients)."""
    flops = (OSC_BWD_FLOPS_SOUNDING * sounding
             + OSC_BWD_FLOPS_SILENT * silent) * up
    return least_seconds(flops, 4 * (10 * b * n_frames * k
                                     + b * n_frames * up))


def osc_cells(controls, sample_rate: int) -> Dict[str, int]:
    """The skipping oscillator's cells at its controls (f_lo, f_hi, a_lo,
    a_hi, phase0), each (B, n_frames, K): 'live' (below Nyquist and not
    silent, K1's work) and 'silent' (below Nyquist, both amplitudes 0:
    K4's cheaper cells)."""
    f_lo, f_hi, a_lo, a_hi = controls[:4]
    audible = torch.minimum(f_lo, f_hi) < sample_rate / 2.0
    quiet = (a_lo == 0) & (a_hi == 0)
    return {'live': int((audible & ~quiet).sum()),
            'silent': int((audible & quiet).sum())}


class ModelFlops(TorchDispatchMode):
    """Counts a model's operations as the reference runs it: 2 m n k a
    matrix product (mm, addmm, bmm, baddbmm, mv, dot) and 2.5 N log2 N a
    real FFT of length N (5 N log2 N complex), per transform. The
    skipping oscillator's work is not dispatched here: the caller adds it
    at K1's count a live term. Elementwise operators are not counted."""

    def __init__(self):
        super().__init__()
        self.matmul = 0.0
        self.fft = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in ('mm', 'addmm', 'bmm', 'baddbmm', 'mv', 'dot'):
            a, b = (args[1], args[2]) if name in ('addmm', 'baddbmm') \
                else (args[0], args[1])
            k = a.shape[-1]
            self.matmul += 2.0 * out.numel() * k
        elif name in ('_fft_r2c', '_fft_c2r', '_fft_c2c'):
            x = args[0]
            dims = args[1]
            if name == '_fft_c2r':
                n = int(args[3])
                total = out.numel()
            else:
                n = math.prod(x.shape[d] for d in dims)
                total = x.numel()
            per = 5.0 if name == '_fft_c2c' else 2.5
            if n > 1:
                self.fft += per * total * math.log2(n)
        return out

    @property
    def total(self) -> float:
        return self.matmul + self.fft


class Count:
    """Counts a reference run's work while it is entered: each GRU call's
    (T, B, u), each skipping-oscillator call's (B, n_frames, K, up) with
    its live and silent cells, and the model's dispatched operations
    (ModelFlops)."""

    def __init__(self, model):
        from portbench.reference.nn.layers import GRU

        self.model = model
        self.gru_class = GRU
        self.grus = []
        self.oscs = []
        self.flops = ModelFlops()
        self._handles = []

    def _gru_hook(self, module, args, output):
        x = args[0]
        self.grus.append((int(x.shape[1]), int(x.shape[0]), module.units))

    def _osc_hook(self, controls, upsampling, sample_rate):
        b, n_frames, k = controls[0].shape
        self.oscs.append(dict(osc_cells(controls, sample_rate), b=int(b),
                              n_frames=int(n_frames), k=int(k),
                              up=int(upsampling)))

    def __enter__(self):
        from portbench.reference.kernels import oscillator

        self._handles = [m.register_forward_hook(self._gru_hook)
                         for m in self.model.modules()
                         if isinstance(m, self.gru_class)]
        oscillator.CONTROL_HOOKS.append(self._osc_hook)
        self.flops.__enter__()
        return self

    def __exit__(self, *exc):
        from portbench.reference.kernels import oscillator

        self.flops.__exit__(*exc)
        oscillator.CONTROL_HOOKS.remove(self._osc_hook)
        for h in self._handles:
            h.remove()
        return False

    def forward_flops(self) -> float:
        """The forward's operations: products and transforms, and K1's
        count a live oscillator term."""
        return self.flops.total + sum(OSC_FLOPS_PER_TERM * o['live'] * o['up']
                                      for o in self.oscs)

    def training_flops(self) -> float:
        """Forward and backward: the backward counted as twice the
        forward's products and transforms, and K4's count a cell."""
        return (3.0 * self.flops.total
                + sum((OSC_FLOPS_PER_TERM + OSC_BWD_FLOPS_SOUNDING)
                      * o['live'] * o['up']
                      + OSC_BWD_FLOPS_SILENT * o['silent'] * o['up']
                      for o in self.oscs))

    def bounds(self, backward: bool = False) -> Dict[str, float]:
        """The least seconds of the kernels this run's shapes launch: K2
        and K1, and with ``backward`` K5 and K4."""
        out = {'gru_scan': sum(gru_seconds(*g) for g in self.grus),
               'oscillator_skip': sum(
                   osc_seconds(o['b'], o['n_frames'], o['k'], o['up'],
                               o['live']) for o in self.oscs)}
        if backward:
            out['gru_scan_bwd'] = sum(gru_bwd_seconds(*g) for g in self.grus)
            out['oscillator_skip_bwd'] = sum(
                osc_bwd_seconds(o['b'], o['n_frames'], o['k'], o['up'],
                                o['live'], o['silent']) for o in self.oscs)
        return out
