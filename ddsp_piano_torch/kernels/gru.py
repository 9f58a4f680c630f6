"""GRU recurrence: CUDA kernels (csrc/gru_scan.cu, csrc/gru_scan_bwd.cu)
and their plain PyTorch versions.

Counterpart of ddsp_piano_tpu/kernels/gru_pallas.py gru_scan (the front
door, :959-968), gru_scan_pallas (the forward kernel), gru_scan_reference
(the plain scan) and gru_scan_pallas_bwd (the backward: a kernel for the
per-step streams, :268-331, then two bulk contractions, :334-353). The TPU
wrappers' fallbacks to the scan or its VJP when VMEM is too small are not
ported: a shape a kernel cannot take raises.

Every function takes ``bf16``: the recurrence of the JAX package's opt-in
bf16 control networks (ddsp_piano_tpu/nn/layers.py enable_bf16_control,
its GRU's lax.scan at :284-304 and that scan's gradient), whose rounding
points gru_scan_plain and gru_scan_plain_bwd state. On the card the C
launch's bf16 argument picks K2's and K5's bf16 template instances,
compiled beside the float32 ones, which stay as they were;
build.BF16_LAUNCHES counts those launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ddsp_piano_torch.device import tensor_device
from ddsp_piano_torch.kernels import build
from ddsp_piano_torch.ops.core import round_bf16

# A launch plan's fields, as gru_scan_plan and gru_scan_bwd_plan fill them
# (gru_plan, csrc/gru_cluster.cuh): CTAs per cluster, batch rows per
# cluster, clusters, threads and shared bytes per CTA, the clusters the
# card keeps resident at once (cudaOccupancyMaxActiveClusters), those
# among them with an SM to each CTA, and units per CTA.
PLAN_FIELDS = ('cluster', 'rows', 'clusters', 'threads', 'smem_bytes',
               'active_clusters', 'exclusive_clusters', 'units_per_cta')


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
                   rec_bias: torch.Tensor, h0: torch.Tensor,
                   bf16: bool = False) -> torch.Tensor:
    """Keras reset_after recurrence, x_proj (T, B, 3u) -> (T, B, u).

    ``bf16``: the recurrent product takes h and U rounded to bfloat16 and
    stays float32 (h U of bf16 values is exact in float32 but for its
    sums); z h takes the unrounded h. That is what XLA compiles the JAX
    package's bf16 scan to on the CPU: the step's jnp.matmul of bf16
    operands returns bf16, but the compiled scan body keeps the float32
    product (no convert of it survives), where it rounds the input
    projection's product outside the scan (nn/layers.py _mm)."""
    u = h0.shape[-1]
    w = round_bf16(rec_kernel) if bf16 else rec_kernel
    h = h0
    hs = []
    for t in range(x_proj.shape[0]):
        rec = torch.matmul(round_bf16(h) if bf16 else h, w) + rec_bias
        z, _, hh, _ = _gates(x_proj[t], rec, u)
        h = z * h + (1.0 - z) * hh
        hs.append(h)
    if not hs:
        return x_proj.new_zeros((0,) + tuple(h0.shape))
    return torch.stack(hs)


def _h_prev(h0: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """(T, B, u) hidden state entering each step."""
    return torch.cat([h0[None], hs[:-1]], dim=0)


def gru_scan_plain_steps(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                         rec_bias: torch.Tensor, h0: torch.Tensor,
                         hs: torch.Tensor, bf16: bool = False
                         ) -> torch.Tensor:
    """Each step of gru_scan_plain taken from the states ``hs`` (a kernel's
    output), all at once: step t from hs[t-1] (h0 first). A kernel within
    float32 rounding of this at every step computes the plain version's
    steps; a run of each on its own drifts apart by more under ``bf16``,
    where a state an ulp apart on the two sides now and then rounds to
    bf16 values 2^-8 apart."""
    u = h0.shape[-1]
    h_prev = _h_prev(h0, hs)
    w = round_bf16(rec_kernel) if bf16 else rec_kernel
    rec = torch.matmul(round_bf16(h_prev) if bf16 else h_prev, w) + rec_bias
    z, _, hh, _ = _gates(x_proj, rec, u)
    return z * h_prev + (1.0 - z) * hh


def gru_scan_plain_bwd(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                       rec_bias: torch.Tensor, h0: torch.Tensor,
                       hs: torch.Tensor, g: torch.Tensor, bf16: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """Per-step gate cotangents of the recurrence (gru_pallas.py:201-232),
    walking time backward and recomputing the gates from (x_proj, h_prev):
    (dxz, dxr, dxh, drh) each (T, B, u), and dh0 (B, u).

    ``bf16``: the gradient of gru_scan_plain's bf16 recurrence as XLA
    compiles jax.grad of the JAX package's bf16 scan on the CPU. The
    converts that survive in its compiled scan body (jax.jit(jax.grad(...))
    .lower(...).compile().as_text()) are: the recompute's h_prev and U
    rounded to bf16 (as in the forward); the cotangent of the recurrent
    product, D = [dz_pre | dr_pre | drh], rounded to bf16 before the
    carry's product D U^T, which stays float32; and each step's weight
    product h_prev^T D, rounded to bf16 (gru_grads_from_streams). The
    streams and dh0 are not rounded: the bias gradients sum them
    unrounded."""
    return _plain_bwd(x_proj, rec_kernel, rec_bias, h0, hs, g, bf16)


def gru_scan_plain_bwd_steps(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                             rec_bias: torch.Tensor, h0: torch.Tensor,
                             hs: torch.Tensor, g: torch.Tensor, streams,
                             bf16: bool = False) -> Tuple[torch.Tensor, ...]:
    """gru_scan_plain_bwd's walk with the carry's product of each step
    taken from the cotangents D = [dxz | dxr | drh] of ``streams`` (a
    kernel's), not from its own: the streams and dh0 that the plain
    version's steps give from the kernel's earlier ones. A kernel within
    float32 rounding of this computes the plain version's steps, where
    under ``bf16`` a run of each on its own drifts apart by the bf16
    steps that a D an ulp apart now and then rounds to."""
    return _plain_bwd(x_proj, rec_kernel, rec_bias, h0, hs, g, bf16,
                      given=streams)


def _plain_bwd(x_proj, rec_kernel, rec_bias, h0, hs, g, bf16, given=None):
    u = h0.shape[-1]
    h_prev = _h_prev(h0, hs)
    w = round_bf16(rec_kernel) if bf16 else rec_kernel
    w_t = [w[:, i * u:(i + 1) * u].t() for i in range(3)]
    rnd = round_bf16 if bf16 else (lambda v: v)
    dh = torch.zeros_like(h0)
    streams = [[None] * x_proj.shape[0] for _ in range(4)]
    for t in range(x_proj.shape[0] - 1, -1, -1):
        hp = h_prev[t]
        rec = torch.matmul(rnd(hp), w) + rec_bias
        z, r, hh, rh = _gates(x_proj[t], rec, u)
        dh = dh + g[t]
        cot = _cotangents(dh, hp, z, r, hh, rh)
        dz_pre, dr_pre, _, drh = (cot if given is None else
                                  (given[0][t], given[1][t], None,
                                   given[3][t]))
        dh = (dh * z + torch.matmul(rnd(dz_pre), w_t[0])
              + torch.matmul(rnd(dr_pre), w_t[1])
              + torch.matmul(rnd(drh), w_t[2]))
        for stream, value in zip(streams, cot):
            stream[t] = value
    if x_proj.shape[0] == 0:
        empty = x_proj.new_zeros((0,) + tuple(h0.shape))
        return empty, empty, empty, empty, dh
    return tuple(torch.stack(s) for s in streams) + (dh,)


def gru_grads_from_streams(h0: torch.Tensor, hs: torch.Tensor, streams,
                           bf16: bool = False, steps_a_chunk: int = 256):
    """(dx_proj, d_rec_kernel, d_rec_bias, dh0) from the per-step streams
    (gru_pallas.py:334-353): the weight gradients are two float32
    contractions of h_prev with the streams over (T * B), the bias
    gradients their sums. ``bf16``: each step's weight product of the
    bf16-rounded h_prev and D = [dxz | dxr | drh], rounded to bf16, summed
    over the steps in float32 (gru_scan_plain_bwd), ``steps_a_chunk``
    steps at a time."""
    dxz, dxr, dxh, drh, dh0 = streams
    u = h0.shape[-1]
    dx_proj = torch.cat([dxz, dxr, dxh], dim=-1)
    parts = (dxz, dxr, drh)
    if bf16:
        h_prev = round_bf16(_h_prev(h0, hs)).transpose(1, 2)
        d = round_bf16(torch.cat(parts, dim=-1))
        d_kernel = sum(
            round_bf16(torch.bmm(h_prev[i:i + steps_a_chunk],
                                 d[i:i + steps_a_chunk])).sum(dim=0)
            for i in range(0, d.shape[0], steps_a_chunk))
    else:
        h_prev = _h_prev(h0, hs).reshape(-1, u)
        d_kernel = torch.matmul(
            h_prev.t(), torch.cat([p.reshape(-1, u) for p in parts],
                                  dim=-1))
    d_bias = torch.cat([p.reshape(-1, u).sum(dim=0) for p in parts])
    return dx_proj, d_kernel, d_bias, dh0


def _check_gru(what, x_proj, rec_kernel, rec_bias, h0):
    if x_proj.dim() != 3:
        raise ValueError(f"x_proj must be (T, B, 3u), got "
                         f"{tuple(x_proj.shape)}")
    t, b, three_u = x_proj.shape
    u = three_u // 3
    args = (x_proj, rec_kernel, rec_bias, h0)
    if any(not a.is_cuda or a.dtype != torch.float32 for a in args):
        raise ValueError(f"{what} takes float32 CUDA tensors")
    if (three_u != 3 * u or tuple(rec_kernel.shape) != (u, three_u)
            or tuple(rec_bias.shape) != (three_u,)
            or tuple(h0.shape) != (b, u)):
        raise ValueError(
            f"{what}: shapes x_proj {tuple(x_proj.shape)}, rec_kernel "
            f"{tuple(rec_kernel.shape)}, rec_bias {tuple(rec_bias.shape)}, "
            f"h0 {tuple(h0.shape)} do not form a GRU of width u = {u}")
    return t, b, u


@functools.lru_cache(maxsize=None)
def _plan(kernel: str, device: int, b: int, u: int) -> Tuple[int, ...]:
    fields = (ctypes.c_int * len(PLAN_FIELDS))()
    code = getattr(build.library(kernel), f'{kernel}_plan')(b, u, fields)
    if code == 1:          # cudaErrorInvalidValue: no plan takes the shape
        raise ValueError(
            f"{kernel}: no launch plan takes B = {b}, u = {u}; u must be a "
            "multiple of 4 up to 256")
    build.check(code, f'{kernel}_plan')
    return tuple(fields)


def launch_plan(kernel: str, b: int, u: int) -> Dict[str, int]:
    """The C plan of ``kernel`` ('gru_scan' or 'gru_scan_bwd') for B rows
    of width u on the current card. Raises ValueError on a shape that no
    plan takes."""
    return dict(zip(PLAN_FIELDS, _plan(kernel, torch.cuda.current_device(),
                                       b, u)))


def _count(kernel: str, bf16: bool) -> None:
    build.LAUNCHES[kernel] += 1
    if bf16:
        build.BF16_LAUNCHES[kernel] += 1


def gru_scan_cuda(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                  rec_bias: torch.Tensor, h0: torch.Tensor,
                  bf16: bool = False) -> torch.Tensor:
    """K2 on CUDA tensors (``bf16``: gru_scan_plain's bf16 recurrence);
    raises on anything it does not take."""
    t, b, u = _check_gru('gru_scan_cuda', x_proj, rec_kernel, rec_bias, h0)
    x, w, bias, h = (a.detach().contiguous()
                     for a in (x_proj, rec_kernel, rec_bias, h0))
    out = torch.empty((t, b, u), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    with torch.cuda.device(x.device):
        plan = launch_plan('gru_scan', b, u)
        if t == 0:
            return out
        code = build.library('gru_scan').gru_scan_launch(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), h.data_ptr(),
            out.data_ptr(), t, b, u, plan['cluster'], plan['rows'],
            int(bf16), build.stream_handle(x.device))
    build.check(code, 'gru_scan_launch')
    _count('gru_scan', bf16)
    return out


def gru_scan_bwd_cuda(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                      rec_bias: torch.Tensor, h0: torch.Tensor,
                      hs: torch.Tensor, g: torch.Tensor, bf16: bool = False
                      ) -> Tuple[torch.Tensor, ...]:
    """K5 on CUDA tensors: the streams of gru_scan_plain_bwd (``bf16``:
    of its bf16 gradient)."""
    t, b, u = _check_gru('gru_scan_bwd_cuda', x_proj, rec_kernel, rec_bias,
                         h0)
    for name, a in (('hs', hs), ('g', g)):
        if (not a.is_cuda or a.dtype != torch.float32
                or tuple(a.shape) != (t, b, u)):
            raise ValueError(f"gru_scan_bwd_cuda: {name} must be a float32 "
                             f"CUDA tensor of ({t}, {b}, {u})")
    x, w, bias, h, hs_c, g_c = (a.detach().contiguous() for a in
                                (x_proj, rec_kernel, rec_bias, h0, hs, g))
    streams = torch.empty((4, t, b, u), dtype=torch.float32, device=x.device)
    dh0 = torch.empty((b, u), dtype=torch.float32, device=x.device)
    if b == 0:
        return tuple(streams) + (dh0,)
    with torch.cuda.device(x.device):
        plan = launch_plan('gru_scan_bwd', b, u)
        if t == 0:
            dh0.zero_()
            return tuple(streams) + (dh0,)
        code = build.library('gru_scan_bwd').gru_scan_bwd_launch(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), h.data_ptr(),
            hs_c.data_ptr(), g_c.data_ptr(), streams.data_ptr(),
            dh0.data_ptr(), t, b, u, plan['cluster'], plan['rows'],
            int(bf16), build.stream_handle(x.device))
    build.check(code, 'gru_scan_bwd_launch')
    _count('gru_scan_bwd', bf16)
    return tuple(streams) + (dh0,)


class GRUScan(torch.autograd.Function):
    """K2 forward and K5 backward (then the two weight contractions); on
    CPU tensors their plain versions. The hidden states are the only
    residual (gru_pallas.py:935-956)."""

    @staticmethod
    def forward(ctx, x_proj, rec_kernel, rec_bias, h0, bf16=False):
        if tensor_device(x_proj, 'gru_scan') == 'cuda':
            hs = gru_scan_cuda(x_proj, rec_kernel, rec_bias, h0, bf16)
        else:
            hs = gru_scan_plain(x_proj, rec_kernel, rec_bias, h0, bf16)
        ctx.save_for_backward(x_proj, rec_kernel, rec_bias, h0, hs)
        ctx.bf16 = bf16
        return hs

    @staticmethod
    def backward(ctx, g):
        x_proj, rec_kernel, rec_bias, h0, hs = ctx.saved_tensors
        bwd = (gru_scan_bwd_cuda if tensor_device(x_proj, 'gru_scan') == 'cuda'
               else gru_scan_plain_bwd)
        streams = bwd(x_proj, rec_kernel, rec_bias, h0, hs, g.contiguous(),
                      ctx.bf16)
        return gru_grads_from_streams(h0, hs, streams, ctx.bf16) + (None,)


def gru_scan(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
             rec_bias: torch.Tensor, h0: torch.Tensor,
             bf16: bool = False) -> torch.Tensor:
    """Front door for nn.GRU. With grad enabled and an input requiring it:
    the GRUScan Function (K2 + K5 on CUDA). Otherwise K2 for CUDA tensors,
    the plain version for CPU tensors. ``bf16``: the recurrence of the
    bf16 control networks (gru_scan_plain)."""
    device = tensor_device(x_proj, 'gru_scan')
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x_proj, rec_kernel, rec_bias, h0)):
        return GRUScan.apply(x_proj, rec_kernel, rec_bias, h0, bf16)
    if device == 'cuda':
        return gru_scan_cuda(x_proj, rec_kernel, rec_bias, h0, bf16)
    return gru_scan_plain(x_proj, rec_kernel, rec_bias, h0, bf16)
