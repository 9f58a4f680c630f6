"""The skipping additive oscillator: the plain PyTorch versions of the
port's K1 and K4 (kernels/oscillator.py at the commit that added the
benchmark), with the autograd Function that pairs them; no CUDA launch.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from portbench.reference.ops.oscillator import (FramewiseOscControls,
                                                render_framewise,
                                                render_framewise_vjp)

TRIG = 'poly'
TRIG_BWD = 'poly4'

# Callables that see the controls of every skipping-oscillator call (the
# benchmark's yardstick counts the live cells there); empty otherwise.
CONTROL_HOOKS: List[Callable[[FramewiseOscControls, int, int], None]] = []


def render_framewise_plain(controls: FramewiseOscControls, upsampling: int,
                           sample_rate: int) -> torch.Tensor:
    return render_framewise(controls, upsampling, sample_rate, trig=TRIG)


def render_framewise_vjp_plain(controls: FramewiseOscControls,
                               g: torch.Tensor, upsampling: int,
                               sample_rate: int) -> FramewiseOscControls:
    return render_framewise_vjp(controls, g, upsampling, sample_rate,
                                trig=TRIG_BWD)


class RenderFramewiseSkip(torch.autograd.Function):
    """The plain forward and its written-out VJP. The five controls are
    the only residual."""

    @staticmethod
    def forward(ctx, upsampling, sample_rate, *controls):
        controls = FramewiseOscControls(*controls)
        audio = render_framewise_plain(controls, upsampling, sample_rate)
        ctx.save_for_backward(*controls)
        ctx.upsampling, ctx.sample_rate = upsampling, sample_rate
        return audio

    @staticmethod
    def backward(ctx, g):
        controls = FramewiseOscControls(*ctx.saved_tensors)
        grads = render_framewise_vjp_plain(controls, g.contiguous(),
                                           ctx.upsampling, ctx.sample_rate)
        return (None, None) + tuple(grads)


def render_framewise_skip(controls: FramewiseOscControls, upsampling: int,
                          sample_rate: int,
                          ) -> torch.Tensor:
    """With grad enabled and a control requiring it, the
    RenderFramewiseSkip Function; otherwise the plain forward."""
    for hook in CONTROL_HOOKS:
        hook(controls, upsampling, sample_rate)
    if torch.is_grad_enabled() and any(c.requires_grad for c in controls):
        return RenderFramewiseSkip.apply(upsampling, sample_rate, *controls)
    return render_framewise_plain(controls, upsampling, sample_rate)
