"""Additive oscillators: CUDA kernels (csrc/oscillator_skip.cu,
csrc/oscillator_skip_bwd.cu, csrc/oscillator_full.cu) and their plain
PyTorch versions.

Counterpart of ddsp_piano_tpu/kernels/oscillator_pallas.py
render_framewise_pallas_skip (forward, K1) and
render_framewise_pallas_skip_vjp (backward, K4), and of the custom_vjp that
ties them together (ops/oscillator.py _render_skip_grad); and of
render_framewise_pallas (K8), the all-partials oscillator with native trig
and no backward, which the JAX package runs under DDSP_PIANO_TPU_PALLAS=1.
The plain versions are ops.oscillator's render_framewise with the forward
kernel's trig ('poly' for K1, 'native' for K8) and render_framewise_vjp
with the backward kernel's ('poly4', the TPU's gradient default when the
forward runs 'poly').
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ddsp_piano_torch.device import tensor_device
from ddsp_piano_torch.kernels import build
from ddsp_piano_torch.ops.oscillator import (FramewiseOscControls,
                                             gradient_tables,
                                             render_framewise,
                                             render_framewise_vjp,
                                             sample_tables)

TRIG = 'poly'
TRIG_BWD = 'poly4'
TRIG_FULL = 'native'
# Frames per block of K1 (csrc/oscillator_skip.cu OSC_FRAMES_PER_BLOCK: a
# thread a sample, so up <= 1024 // frames per block).
SKIP_FRAMES_PER_BLOCK = 4
# K8's plan (csrc/oscillator_full.cu, whose constants these state and whose
# launch checks them): a warp a frame, FULL_FRAMES_PER_BLOCK frames a
# block, each lane up / 32 samples (rounded up) of its frame, at most
# FULL_MAX_SAMPLES_PER_LANE, so up <= 256; shared memory a float4 and a
# float a cell and an int a frame.
FULL_FRAMES_PER_BLOCK = 4
FULL_MAX_SAMPLES_PER_LANE = 8
SMEM_LIMIT = 232448             # a block's shared memory on sm_90

# (up, sample_rate, device) -> (table on the device, its host copy).
_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def osc_tables(upsampling: int, sample_rate: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The oscillator kernels' per-sample table, (7, up) float32, rows h,
    tri, s + 1, s / up (what K8 reads), 1 - h and the two frequency weights
    (csrc/oscillator_common.cuh), computed on ``device`` by the plain
    version's own sample_tables / gradient_tables, so bit for bit its
    values. Cached per (up, sample_rate, device) with a host copy, which K4
    takes as a kernel parameter: only a key's first call waits for the
    device."""
    key = (int(upsampling), int(sample_rate), torch.device(device))
    tables = _TABLES.get(key)
    if tables is None:
        h, tri, s1, s_frac = sample_tables(key[0], key[2])
        w_alo, _, w_flo, w_fhi = gradient_tables(key[0], key[1], key[2])
        table = torch.stack([h, tri, s1, s_frac, w_alo, w_flo,
                             w_fhi]).contiguous()
        tables = _TABLES[key] = (table, table.cpu())
    return tables


def render_framewise_plain(controls: FramewiseOscControls, upsampling: int,
                           sample_rate: int) -> torch.Tensor:
    return render_framewise(controls, upsampling, sample_rate, trig=TRIG)


def render_framewise_vjp_plain(controls: FramewiseOscControls,
                               g: torch.Tensor, upsampling: int,
                               sample_rate: int) -> FramewiseOscControls:
    return render_framewise_vjp(controls, g, upsampling, sample_rate,
                                trig=TRIG_BWD)


def active_partials(controls: FramewiseOscControls,
                    sample_rate: int) -> torch.Tensor:
    """(b, n_frames) one past each frame's last active partial: the
    forward kernel's loop bound, with the TPU kernel's activity predicate."""
    f_lo, f_hi, a_lo, a_hi, _ = controls
    active = ((torch.minimum(f_lo, f_hi) < sample_rate / 2.0)
              & ((a_lo != 0.0) | (a_hi != 0.0)))
    k_idx = torch.arange(1, f_lo.shape[-1] + 1, device=f_lo.device)
    return torch.amax(torch.where(active, k_idx, 0), dim=-1)


def audible_partials(controls: FramewiseOscControls,
                     sample_rate: int) -> torch.Tensor:
    """(b, n_frames) one past each frame's last partial below Nyquist: the
    backward kernel's loop bound (Nyquist only, oscillator_pallas.py:
    496-501: a silent partial still has amplitude gradients)."""
    f_lo, f_hi = controls.f_lo, controls.f_hi
    audible = torch.minimum(f_lo, f_hi) < sample_rate / 2.0
    k_idx = torch.arange(1, f_lo.shape[-1] + 1, device=f_lo.device)
    return torch.amax(torch.where(audible, k_idx, 0), dim=-1)


def _check_controls(what, controls):
    shape = tuple(controls.f_lo.shape)
    if len(shape) != 3:
        raise ValueError(f"controls must be (B, n_frames, K), got {shape}")
    for c in controls:
        if (not c.is_cuda or c.dtype != torch.float32
                or tuple(c.shape) != shape
                or c.device != controls.f_lo.device):
            raise ValueError(f"{what} takes five float32 CUDA tensors of one "
                             f"shape {shape}")
    return shape


def _forward_args(what: str, controls: FramewiseOscControls,
                  upsampling: int, sample_rate: int):
    """The C arguments of K1 and K8 but their plan, and the output: the
    five contiguous controls, the table, out, B, n_frames, K, up, w_scale
    and Nyquist."""
    b, n_frames, k = _check_controls(what, controls)
    up = int(upsampling)
    device = controls.f_lo.device
    table, _ = osc_tables(up, sample_rate, device)
    parts = [c.detach().contiguous() for c in controls]
    out = torch.empty((b, n_frames * up), dtype=torch.float32, device=device)
    args = (*(p.data_ptr() for p in parts), table.data_ptr(), out.data_ptr(),
            b, n_frames, k, up, 2.0 * math.pi / float(sample_rate),
            float(sample_rate) / 2.0)
    return args, out


def render_framewise_skip_cuda(controls: FramewiseOscControls,
                               upsampling: int,
                               sample_rate: int) -> torch.Tensor:
    """K1 on CUDA tensors; raises on anything it does not take."""
    what = 'the oscillator_skip kernel'
    if SKIP_FRAMES_PER_BLOCK * int(upsampling) > 1024:
        raise ValueError(f"{what} takes up <= "
                         f"{1024 // SKIP_FRAMES_PER_BLOCK}, got {upsampling}")
    _check_controls(what, controls)
    device = controls.f_lo.device
    with torch.cuda.device(device):
        args, out = _forward_args(what, controls, upsampling, sample_rate)
        if out.numel() == 0:
            return out
        code = build.library('oscillator_skip').osc_skip_launch(
            *args, build.stream_handle(device))
    build.check(code, 'osc_skip_launch')
    build.LAUNCHES['oscillator_skip'] += 1
    return out


def render_framewise_skip_bwd_cuda(controls: FramewiseOscControls,
                                   g: torch.Tensor, upsampling: int,
                                   sample_rate: int) -> FramewiseOscControls:
    """K4 on CUDA tensors: the five control gradients from the audio
    cotangent g (B, n_frames * up)."""
    b, n_frames, k = _check_controls('render_framewise_skip_bwd_cuda',
                                     controls)
    up = int(upsampling)
    device = controls.f_lo.device
    if (not g.is_cuda or g.dtype != torch.float32
            or tuple(g.shape) != (b, n_frames * up)):
        raise ValueError("render_framewise_skip_bwd_cuda: g must be a "
                         f"float32 CUDA tensor of ({b}, {n_frames * up})")
    if k > 1024:
        raise ValueError(f"render_framewise_skip_bwd_cuda takes K <= 1024 "
                         f"partials, got {k}")
    with torch.cuda.device(device):
        table, table_host = osc_tables(up, sample_rate, device)
        parts = [c.detach().contiguous() for c in controls]
        g_c = g.detach().contiguous()
        grads = torch.empty((5, b, n_frames, k), dtype=torch.float32,
                            device=device)
        if grads.numel() == 0:
            return FramewiseOscControls(*grads)
        lib = build.library('oscillator_skip_bwd')
        code = lib.osc_skip_bwd_launch(
            *(p.data_ptr() for p in parts), g_c.data_ptr(),
            table.data_ptr(), table_host.data_ptr(), grads.data_ptr(), b,
            n_frames, k, up, 2.0 * math.pi / float(sample_rate),
            float(sample_rate) / 2.0, build.stream_handle(device))
    build.check(code, 'osc_skip_bwd_launch')
    build.LAUNCHES['oscillator_skip_bwd'] += 1
    return FramewiseOscControls(*grads)


class RenderFramewiseSkip(torch.autograd.Function):
    """K1 forward and K4 backward; on CPU tensors their plain versions.
    The five controls are the only residual (ops/oscillator.py:485-495)."""

    @staticmethod
    def forward(ctx, upsampling, sample_rate, *controls):
        controls = FramewiseOscControls(*controls)
        if tensor_device(controls.f_lo, 'render_framewise_skip') == 'cuda':
            audio = render_framewise_skip_cuda(controls, upsampling,
                                               sample_rate)
        else:
            audio = render_framewise_plain(controls, upsampling, sample_rate)
        ctx.save_for_backward(*controls)
        ctx.upsampling, ctx.sample_rate = upsampling, sample_rate
        return audio

    @staticmethod
    def backward(ctx, g):
        controls = FramewiseOscControls(*ctx.saved_tensors)
        bwd = (render_framewise_skip_bwd_cuda
               if tensor_device(controls.f_lo,
                                'render_framewise_skip') == 'cuda'
               else render_framewise_vjp_plain)
        grads = bwd(controls, g.contiguous(), ctx.upsampling,
                    ctx.sample_rate)
        return (None, None) + tuple(grads)


def render_framewise_skip(controls: FramewiseOscControls, upsampling: int,
                          sample_rate: int) -> torch.Tensor:
    """Front door for processors.inharm. With grad enabled and a control
    requiring it: the RenderFramewiseSkip Function (K1 + K4 on CUDA).
    Otherwise K1 for CUDA tensors, the plain version for CPU tensors."""
    device = tensor_device(controls.f_lo, 'render_framewise_skip')
    if torch.is_grad_enabled() and any(c.requires_grad for c in controls):
        return RenderFramewiseSkip.apply(upsampling, sample_rate, *controls)
    if device == 'cuda':
        return render_framewise_skip_cuda(controls, upsampling, sample_rate)
    return render_framewise_plain(controls, upsampling, sample_rate)


def render_framewise_full_plain(controls: FramewiseOscControls,
                                upsampling: int,
                                sample_rate: int) -> torch.Tensor:
    return render_framewise(controls, upsampling, sample_rate,
                            trig=TRIG_FULL)


def osc_full_plan(b: int, n_frames: int, k: int,
                  upsampling: int) -> Dict[str, int]:
    """K8's launch plan for (B, n_frames, K) controls at ``upsampling``
    samples a frame: frames a block (a warp each), threads a block, samples
    a lane, the grid (frame runs, voices) and dynamic shared bytes a
    block. Raises ValueError on what the launch refuses: up < 1 or over
    32 x FULL_MAX_SAMPLES_PER_LANE, K < 1, B over 65535 (the grid's second
    dimension), or shared memory over a block's limit."""
    up = int(upsampling)
    ns = -(-up // 32)
    fpb = FULL_FRAMES_PER_BLOCK
    smem = (16 + 4) * fpb * k + 4 * fpb
    if up < 1 or ns > FULL_MAX_SAMPLES_PER_LANE:
        raise ValueError(f"the oscillator_full kernel takes 1 <= up <= "
                         f"{32 * FULL_MAX_SAMPLES_PER_LANE}, got {up}")
    if k < 1 or b > 65535 or smem > SMEM_LIMIT:
        raise ValueError(f"the oscillator_full kernel takes 1 <= K with "
                         f"{smem} <= {SMEM_LIMIT} shared bytes and B <= "
                         f"65535; got K={k}, B={b}")
    return dict(frames_per_block=fpb, threads=32 * fpb, samples_per_lane=ns,
                grid=(-(-n_frames // fpb), b), smem_bytes=smem)


def render_framewise_full_cuda(controls: FramewiseOscControls,
                               upsampling: int,
                               sample_rate: int) -> torch.Tensor:
    """K8 on CUDA tensors; raises on anything it does not take."""
    _check_controls('the oscillator_full kernel', controls)
    device = controls.f_lo.device
    with torch.cuda.device(device):
        args, out = _forward_args('the oscillator_full kernel', controls,
                                  upsampling, sample_rate)
        plan = osc_full_plan(*controls.f_lo.shape, upsampling)
        if out.numel() == 0:
            return out
        code = build.library('oscillator_full').osc_full_launch(
            *args, plan['frames_per_block'], plan['samples_per_lane'],
            plan['smem_bytes'], build.stream_handle(device))
    build.check(code, 'osc_full_launch')
    build.LAUNCHES['oscillator_full'] += 1
    return out


def render_framewise_full(controls: FramewiseOscControls, upsampling: int,
                          sample_rate: int) -> torch.Tensor:
    """Front door of the all-partials oscillator, forward only: K8 for CUDA
    tensors, its plain version for CPU tensors. Raises when a control
    requires grad: K8 has no backward, as the JAX package's
    backend='pallas' has no VJP (train with the skipping oscillator)."""
    device = tensor_device(controls.f_lo, 'render_framewise_full')
    if torch.is_grad_enabled() and any(c.requires_grad for c in controls):
        raise ValueError("render_framewise_full is forward-only (K8 has no "
                         "backward): use the skipping oscillator for "
                         "gradients")
    if device == 'cuda':
        return render_framewise_full_cuda(controls, upsampling, sample_rate)
    return render_framewise_full_plain(controls, upsampling, sample_rate)
