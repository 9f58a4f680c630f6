"""GRU recurrence: the plain PyTorch versions of the port's K2 and K5
(kernels/gru.py at the commit that added the benchmark), in float32,
with the autograd Function that pairs them; no CUDA launch.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _gates(xt: torch.Tensor, rec: torch.Tensor, u: int):
    """(z, r, hh, rh) of a step from its input projection and h U + b."""
    rh = rec[..., 2 * u:]
    z = torch.sigmoid(xt[..., :u] + rec[..., :u])
    r = torch.sigmoid(xt[..., u:2 * u] + rec[..., u:2 * u])
    hh = torch.tanh(xt[..., 2 * u:] + r * rh)
    return z, r, hh, rh


def _cotangents(d, hp, z, r, hh, rh):
    """A step's (dz_pre, dr_pre, dpre, drh) from the cotangent d of its
    output (gru_pallas.py:201-232)."""
    dz = d * (hp - hh)
    dpre = (d * (1.0 - z)) * (1.0 - hh * hh)      # d(xh + r rh)
    drh = dpre * r                                # d(h Uh + bh)
    dr_pre = (dpre * rh) * (r * (1.0 - r))        # d(xr + rr)
    dz_pre = dz * (z * (1.0 - z))                 # d(xz + rz)
    return dz_pre, dr_pre, dpre, drh


def gru_scan_plain(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                   rec_bias: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Keras reset_after recurrence, x_proj (T, B, 3u) -> (T, B, u)."""
    u = h0.shape[-1]
    h = h0
    hs = []
    for t in range(x_proj.shape[0]):
        rec = torch.matmul(h, rec_kernel) + rec_bias
        z, _, hh, _ = _gates(x_proj[t], rec, u)
        h = z * h + (1.0 - z) * hh
        hs.append(h)
    if not hs:
        return x_proj.new_zeros((0,) + tuple(h0.shape))
    return torch.stack(hs)


def _h_prev(h0: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """(T, B, u) hidden state entering each step."""
    return torch.cat([h0[None], hs[:-1]], dim=0)


def gru_scan_plain_bwd(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                       rec_bias: torch.Tensor, h0: torch.Tensor,
                       hs: torch.Tensor, g: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """Per-step gate cotangents of the recurrence (gru_pallas.py:201-232),
    walking time backward and recomputing the gates from (x_proj, h_prev):
    (dxz, dxr, dxh, drh) each (T, B, u), and dh0 (B, u)."""
    u = h0.shape[-1]
    h_prev = _h_prev(h0, hs)
    w_t = [rec_kernel[:, i * u:(i + 1) * u].t() for i in range(3)]
    dh = torch.zeros_like(h0)
    streams = [[None] * x_proj.shape[0] for _ in range(4)]
    for t in range(x_proj.shape[0] - 1, -1, -1):
        hp = h_prev[t]
        rec = torch.matmul(hp, rec_kernel) + rec_bias
        z, r, hh, rh = _gates(x_proj[t], rec, u)
        dh = dh + g[t]
        cot = _cotangents(dh, hp, z, r, hh, rh)
        dz_pre, dr_pre, _, drh = cot
        dh = (dh * z + torch.matmul(dz_pre, w_t[0])
              + torch.matmul(dr_pre, w_t[1])
              + torch.matmul(drh, w_t[2]))
        for stream, value in zip(streams, cot):
            stream[t] = value
    if x_proj.shape[0] == 0:
        empty = x_proj.new_zeros((0,) + tuple(h0.shape))
        return empty, empty, empty, empty, dh
    return tuple(torch.stack(s) for s in streams) + (dh,)


def gru_grads_from_streams(h0: torch.Tensor, hs: torch.Tensor, streams):
    """(dx_proj, d_rec_kernel, d_rec_bias, dh0) from the per-step streams
    (gru_pallas.py:334-353): the weight gradients are two float32
    contractions of h_prev with the streams over (T * B), the bias
    gradients their sums."""
    dxz, dxr, dxh, drh, dh0 = streams
    u = h0.shape[-1]
    dx_proj = torch.cat([dxz, dxr, dxh], dim=-1)
    parts = (dxz, dxr, drh)
    h_prev = _h_prev(h0, hs).reshape(-1, u)
    d_kernel = torch.matmul(
        h_prev.t(), torch.cat([p.reshape(-1, u) for p in parts], dim=-1))
    d_bias = torch.cat([p.reshape(-1, u).sum(dim=0) for p in parts])
    return dx_proj, d_kernel, d_bias, dh0


class GRUScan(torch.autograd.Function):
    """K2 forward and K5 backward (then the two weight contractions); on
    CPU tensors their plain versions. The hidden states are the only
    residual (gru_pallas.py:935-956)."""

    @staticmethod
    def forward(ctx, x_proj, rec_kernel, rec_bias, h0):
        hs = gru_scan_plain(x_proj, rec_kernel, rec_bias, h0)
        ctx.save_for_backward(x_proj, rec_kernel, rec_bias, h0, hs)
        return hs

    @staticmethod
    def backward(ctx, g):
        x_proj, rec_kernel, rec_bias, h0, hs = ctx.saved_tensors
        streams = gru_scan_plain_bwd(x_proj, rec_kernel, rec_bias, h0, hs,
                                     g.contiguous())
        return gru_grads_from_streams(h0, hs, streams)


def gru_scan(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
             rec_bias: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Front door for nn.GRU: with grad enabled and an input requiring it,
    the GRUScan Function; otherwise the plain recurrence."""
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x_proj, rec_kernel, rec_bias, h0)):
        return GRUScan.apply(x_proj, rec_kernel, rec_bias, h0)
    return gru_scan_plain(x_proj, rec_kernel, rec_bias, h0)
