"""The surrogate synth's decaying partials: CUDA kernels
(csrc/oscillator_decay.cu, K10, and csrc/oscillator_decay_bwd.cu, K11) and
their plain PyTorch versions.

The JAX package renders these partials in plain jnp and differentiates
them with jax.grad (ddsp_piano_tpu/processors/surrogate.py); it has no
Pallas site for them. K10 is K1's skipping render with an envelope
exp(log|d| (up T + s)) on each term, K11 K4's reduction with the
envelope and the gradients of the decays and of T. The plain versions
are ops.oscillator's render_framewise_decay (torch.cos, torch.exp) and
render_framewise_decay_vjp (torch.sin and torch.cos), which the kernels
follow: K8's accurate cosine and expf in K10, sincosf and expf in K11.
"""

from __future__ import annotations

import math

import torch

from ddsp_piano_torch.device import tensor_device
from ddsp_piano_torch.kernels import build
from ddsp_piano_torch.kernels.oscillator import (SKIP_FRAMES_PER_BLOCK,
                                                 _check_controls, osc_tables)
from ddsp_piano_torch.ops import core
from ddsp_piano_torch.ops.oscillator import (DecayGrads,
                                             FramewiseOscControls,
                                             render_framewise_decay,
                                             render_framewise_decay_vjp)

# Gradient planes K11 writes: the five controls', the decays', and each
# cell's share of the gradient of T before the sum over partials.
DECAY_GRADS = 7


def _check_decays(what, controls, decays, decay_time):
    b, n_frames, k = _check_controls(what, controls)
    device = controls.f_lo.device
    for x, shape in ((decays, (b, n_frames, k)),
                     (decay_time, (b, n_frames, 1))):
        if (not x.is_cuda or x.dtype != torch.float32
                or tuple(x.shape) != shape or x.device != device):
            raise ValueError(f"{what} takes float32 CUDA decays of "
                             f"{(b, n_frames, k)} and decay_time of "
                             f"{(b, n_frames, 1)} on {device}")
    return b, n_frames, k


def render_framewise_decay_cuda(controls: FramewiseOscControls,
                                decays: torch.Tensor,
                                decay_time: torch.Tensor, upsampling: int,
                                sample_rate: int) -> torch.Tensor:
    """K10 on CUDA tensors; raises on anything it does not take."""
    what = 'the oscillator_decay kernel'
    up = int(upsampling)
    if SKIP_FRAMES_PER_BLOCK * up > 1024:
        raise ValueError(f"{what} takes up <= "
                         f"{1024 // SKIP_FRAMES_PER_BLOCK}, got {up}")
    b, n_frames, k = _check_decays(what, controls, decays, decay_time)
    device = controls.f_lo.device
    with torch.cuda.device(device):
        table, _ = osc_tables(up, sample_rate, device)
        parts = [c.detach().contiguous() for c in controls]
        dec = decays.detach().contiguous()
        dt = decay_time.detach().contiguous()
        out = torch.empty((b, n_frames * up), dtype=torch.float32,
                          device=device)
        if out.numel() == 0:
            return out
        code = build.library('oscillator_decay').osc_decay_launch(
            *(p.data_ptr() for p in parts), dec.data_ptr(), dt.data_ptr(),
            table.data_ptr(), out.data_ptr(), b, n_frames, k, up,
            2.0 * math.pi / float(sample_rate), float(sample_rate) / 2.0,
            build.stream_handle(device))
    build.check(code, 'osc_decay_launch')
    build.LAUNCHES['oscillator_decay'] += 1
    return out


def render_framewise_decay_bwd_cuda(controls: FramewiseOscControls,
                                    decays: torch.Tensor,
                                    decay_time: torch.Tensor,
                                    g: torch.Tensor, upsampling: int,
                                    sample_rate: int) -> DecayGrads:
    """K11 on CUDA tensors: the gradients of the controls, the decays and
    decay_time from the audio cotangent g (B, n_frames * up)."""
    what = 'render_framewise_decay_bwd_cuda'
    b, n_frames, k = _check_decays(what, controls, decays, decay_time)
    up = int(upsampling)
    device = controls.f_lo.device
    if (not g.is_cuda or g.dtype != torch.float32
            or tuple(g.shape) != (b, n_frames * up) or g.device != device):
        raise ValueError(f"{what}: g must be a float32 CUDA tensor of "
                         f"({b}, {n_frames * up}) on {device}")
    if k > 1024:
        raise ValueError(f"{what} takes K <= 1024 partials, got {k}")
    with torch.cuda.device(device):
        table, _ = osc_tables(up, sample_rate, device)
        parts = [c.detach().contiguous() for c in controls]
        dec = decays.detach().contiguous()
        dt = decay_time.detach().contiguous()
        g_c = g.detach().contiguous()
        grads = torch.empty((DECAY_GRADS, b, n_frames, k),
                            dtype=torch.float32, device=device)
        if grads.numel() == 0:
            return DecayGrads(FramewiseOscControls(*grads[:5]), grads[5],
                              grads[6, ..., :1])
        code = build.library('oscillator_decay_bwd').osc_decay_bwd_launch(
            *(p.data_ptr() for p in parts), dec.data_ptr(), dt.data_ptr(),
            g_c.data_ptr(), table.data_ptr(), grads.data_ptr(), b, n_frames,
            k, up, 2.0 * math.pi / float(sample_rate),
            float(sample_rate) / 2.0, build.stream_handle(device))
        build.check(code, 'osc_decay_bwd_launch')
        d_time = torch.sum(grads[6], dim=-1, keepdim=True) * float(up)
    build.LAUNCHES['oscillator_decay_bwd'] += 1
    return DecayGrads(FramewiseOscControls(*grads[:5]), grads[5], d_time)


class RenderFramewiseDecay(torch.autograd.Function):
    """K10 forward and K11 backward; on CPU tensors their plain versions.
    The decays, decay_time and the five controls are the residuals."""

    @staticmethod
    def forward(ctx, upsampling, sample_rate, decays, decay_time,
                *controls):
        controls = FramewiseOscControls(*controls)
        if tensor_device(controls.f_lo, 'render_framewise_decay') == 'cuda':
            audio = render_framewise_decay_cuda(controls, decays, decay_time,
                                                upsampling, sample_rate)
        else:
            audio = render_framewise_decay(controls, decays, decay_time,
                                           upsampling, sample_rate)
        ctx.save_for_backward(decays, decay_time, *controls)
        ctx.upsampling, ctx.sample_rate = upsampling, sample_rate
        return audio

    @staticmethod
    def backward(ctx, g):
        decays, decay_time, *controls = ctx.saved_tensors
        controls = FramewiseOscControls(*controls)
        bwd = (render_framewise_decay_bwd_cuda
               if tensor_device(controls.f_lo,
                                'render_framewise_decay') == 'cuda'
               else render_framewise_decay_vjp)
        grads = bwd(controls, decays, decay_time, g.contiguous(),
                    ctx.upsampling, ctx.sample_rate)
        return ((None, None, grads.decays, grads.decay_time)
                + tuple(grads.controls))


def render_framewise_decay_skip(controls: FramewiseOscControls,
                                decays: torch.Tensor,
                                decay_time: torch.Tensor, upsampling: int,
                                sample_rate: int) -> torch.Tensor:
    """Front door for processors.surrogate. With grad enabled and an input
    requiring it: the RenderFramewiseDecay Function (K10 + K11 on CUDA).
    Otherwise K10 for CUDA tensors, the plain version for CPU tensors."""
    decays, decay_time = core.f32(decays), core.f32(decay_time)
    device = tensor_device(controls.f_lo, 'render_framewise_decay')
    inputs = (decays, decay_time, *controls)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return RenderFramewiseDecay.apply(upsampling, sample_rate, decays,
                                          decay_time, *controls)
    if device == 'cuda':
        return render_framewise_decay_cuda(controls, decays, decay_time,
                                           upsampling, sample_rate)
    return render_framewise_decay(controls, decays, decay_time, upsampling,
                                  sample_rate)
