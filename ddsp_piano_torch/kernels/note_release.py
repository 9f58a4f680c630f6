"""NoteRelease recurrence: CUDA kernels (csrc/note_release.cu,
csrc/note_release_bwd.cu) and their plain PyTorch versions.

Counterpart of ddsp_piano_tpu/kernels/gru_pallas.py: note_release_scan
(the front door), note_release_reference (the plain scan),
note_release_scan_pallas_res (forward with the pre-update ``steps``
stream) and note_release_scan_pallas_bwd (the reverse walk).

Gradients follow JAX's conventions at the ties that real data hits
(``steps`` counts whole frames and the threshold can be integral, so
``steps - threshold`` lands on 0 and 1): d relu(u)/du = 0 at u = 0 and
d min(r, 1)/dr = 0.5 at r = 1 (gru_pallas.py:533-538). Torch's autograd of
``clamp`` has gradient 1 at both ties, so the gradient is written out
(:func:`note_release_scan_plain_bwd`) and never taken from autograd.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ddsp_piano_torch.device import tensor_device
from ddsp_piano_torch.kernels import build


def _sat_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.clamp(x, min=0.0), max=1.0)


def _note_release_step(note, prev, steps, thr):
    activity = _sat_relu(note)
    release_end = _sat_relu(steps - thr)
    out = activity * note + (1.0 - activity) * prev * (1.0 - release_end)
    new_steps = (steps + 1.0) * (1.0 - activity) * (1.0 - release_end)
    return out, new_steps


def note_release_scan_plain_res(active_pitch: torch.Tensor,
                                threshold: torch.Tensor,
                                state0: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(T, B, 1) pitch, (1,) threshold in frames, (B, 2) state ->
    ((T, B, 1) extended pitch, (B, 2) final state, (T, B) pre-update
    steps).

    Same operations in the same order as the kernels, so they agree bit
    for bit."""
    x = active_pitch[..., 0]
    thr = threshold.reshape(())
    prev = state0[:, 0]
    steps = state0[:, 1]
    outs, pre_steps = [], []
    for t in range(x.shape[0]):
        pre_steps.append(steps)
        prev, steps = _note_release_step(x[t], prev, steps, thr)
        outs.append(prev)
    if not outs:
        return (x[..., None].clone(), torch.stack([prev, steps], dim=-1),
                x.clone())
    return (torch.stack(outs)[..., None], torch.stack([prev, steps], dim=-1),
            torch.stack(pre_steps))


def note_release_scan_plain(active_pitch: torch.Tensor,
                            threshold: torch.Tensor,
                            state0: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, B, 1) pitch, (1,) threshold in frames, (B, 2) state ->
    ((T, B, 1) extended pitch, (B, 2) final state)."""
    ys, state, _ = note_release_scan_plain_res(active_pitch, threshold,
                                               state0)
    return ys, state


def sat_relu_mask(u: torch.Tensor) -> torch.Tensor:
    """d/du of min(relu(u), 1) under JAX's conventions: 0 at u == 0, and
    0.5 where relu(u) == 1 (gru_pallas.py:533-538)."""
    r = torch.clamp(u, min=0.0)
    inner = torch.where(r < 1.0, 1.0, torch.where(r == 1.0, 0.5, 0.0))
    return torch.where(u > 0.0, inner, 0.0)


def note_release_scan_plain_bwd(active_pitch: torch.Tensor,
                                threshold: torch.Tensor,
                                prev: torch.Tensor, steps: torch.Tensor,
                                g_out: torch.Tensor, g_state: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Reverse NoteRelease walk (gru_pallas.py:541-601).

    active_pitch (T, B, 1); threshold (1,); prev and steps (T, B), the
    pre-step held note and release count; g_out (T, B, 1) and g_state
    (B, 2) the cotangents of the outputs. Returns (dx (T, B), per-lane
    dthreshold (B,), dstate0 (B, 2)); the caller sums dthreshold over the
    lanes."""
    x = active_pitch[..., 0]
    g = g_out[..., 0]
    thr = threshold.reshape(())
    d_prev = g_state[:, 0]
    d_steps = g_state[:, 1]
    dthr = torch.zeros_like(d_prev)
    dx = [None] * x.shape[0]
    for t in range(x.shape[0] - 1, -1, -1):
        note, p, s = x[t], prev[t], steps[t]
        a = _sat_relu(note)
        u_e = s - thr
        e = _sat_relu(u_e)
        mask_a = sat_relu_mask(note)
        mask_e = sat_relu_mask(u_e)
        one_a = 1.0 - a
        one_e = 1.0 - e
        g_o = g[t] + d_prev
        g_n = d_steps
        # out = a note + (1 - a) prev (1 - e); ns = (s + 1)(1 - a)(1 - e)
        g_e = -(g_o * p + g_n * (s + 1.0)) * one_a
        g_a = g_o * (note - p * one_e) - g_n * (s + 1.0) * one_e
        dx[t] = g_o * a + g_a * mask_a
        d_prev = g_o * one_a * one_e
        d_steps = g_n * one_a * one_e + g_e * mask_e
        dthr = dthr + g_e * (-mask_e)
    dx = torch.stack(dx) if dx else x.clone()
    return dx, dthr, torch.stack([d_prev, d_steps], dim=-1)


def _check_inputs(what, active_pitch, threshold, state0):
    if active_pitch.dim() != 3 or active_pitch.shape[-1] != 1:
        raise ValueError(f"active_pitch must be (T, B, 1), got "
                         f"{tuple(active_pitch.shape)}")
    b = active_pitch.shape[1]
    args = (active_pitch, threshold, state0)
    if any(not a.is_cuda or a.dtype != torch.float32 for a in args):
        raise ValueError(f"{what} takes float32 CUDA tensors")
    if threshold.numel() != 1 or tuple(state0.shape) != (b, 2):
        raise ValueError("threshold must have one element and state0 be "
                         f"(B, 2); got {tuple(threshold.shape)}, "
                         f"{tuple(state0.shape)}")
    return (active_pitch.detach().contiguous(),
            threshold.detach().contiguous(), state0.detach().contiguous())


# K3 / K6 / K7 launch plan (csrc/note_release_ring.cuh, whose constants it
# states and whose launch checks them). A block is one consumer warp (a
# thread a lane of its slice) and one producer warp; its input streams
# pass through a ring of NR_STAGES (NR_TILE, NR_LANES) tiles in shared
# memory, after NR_RING_OFFSET bytes of mbarriers (each tile starts on 128
# bytes, as a TMA box's destination must). A probe on the H100 chose the
# plan (PERF.md).
NR_LANES = 32
NR_TILE = 64
NR_STAGES = 2
NR_RING_OFFSET = 128
NR_SMEM_LIMIT = 232448          # a block's shared memory on sm_90
NR_STREAMS = {'note_release': 1, 'note_release_res': 1,
              'note_release_bwd': 4}


def note_release_plan(kernel: str, t: int, b: int) -> Dict[str, int]:
    """The launch plan of K3 ('note_release'), K6 ('note_release_res') or
    K7 ('note_release_bwd') for T steps of B lanes: lanes a block, steps a
    tile, ring stages, the lanes launched (B padded to a multiple of 4, so
    that a stream's rows meet the TMA box's 16-byte rule), blocks (of 64
    threads: a consumer and a producer warp), dynamic shared bytes a
    block, and tiles; raises ValueError on T < 0 or B < 1."""
    if b < 1 or t < 0:
        raise ValueError(f"no {kernel} plan for T={t}, B={b}")
    smem = (NR_RING_OFFSET
            + NR_STAGES * NR_STREAMS[kernel] * NR_TILE * NR_LANES * 4)
    padded = -(-b // 4) * 4
    return dict(lanes=NR_LANES, tile_t=NR_TILE, stages=NR_STAGES,
                padded_b=padded, blocks=-(-padded // NR_LANES),
                smem_bytes=smem, tiles=-(-t // NR_TILE))


def _launchable(a: torch.Tensor, lanes: int, dim: int) -> torch.Tensor:
    """``a`` itself, or a copy with its lane dimension ``dim`` zero-padded
    to ``lanes`` (the plan's padded B) and its data on the 16 bytes a TMA
    descriptor's base needs (a view into a larger tensor may start
    anywhere)."""
    if a.shape[dim] == lanes and a.data_ptr() % 16 == 0:
        return a
    shape = list(a.shape)
    shape[dim] = lanes
    out = a.new_zeros(shape)
    out.narrow(dim, 0, a.shape[dim]).copy_(a)
    return out


def launch_note_release(kernel: str, args, plan: Dict[str, int]):
    """Launch K3 or K6 (args: x (T, B, 1), threshold, state0) or K7 (args:
    x, threshold, prev (T, B), steps (T, B), g_out (T, B), g_state (B, 2)),
    contiguous float32 CUDA tensors, under ``plan`` (B's lanes zero-padded
    to the plan's, the outputs cut back to B); returns the outputs."""
    with torch.cuda.device(args[0].device):
        return _launch_note_release(kernel, args, plan)


def _launch_note_release(kernel: str, args, plan: Dict[str, int]):
    thr = args[1]
    t, b, _ = args[0].shape
    lanes = plan['padded_b']
    x = _launchable(args[0], lanes, 1)
    stream = build.stream_handle(x.device)
    layout = (plan['lanes'], plan['tile_t'], plan['stages'],
              plan['smem_bytes'])
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=x.device)
    if kernel == 'note_release':
        s0 = _launchable(args[2], lanes, 0)
        out, state = new(t, lanes, 1), new(lanes, 2)
        code = build.library('note_release').note_release_launch(
            x.data_ptr(), thr.data_ptr(), s0.data_ptr(), out.data_ptr(),
            state.data_ptr(), t, lanes, *layout, stream)
        outputs, dims = (out, state), (1, 0)
    elif kernel == 'note_release_res':
        s0 = _launchable(args[2], lanes, 0)
        out, state, steps = new(t, lanes, 1), new(lanes, 2), new(t, lanes)
        code = build.library('note_release_bwd').note_release_res_launch(
            x.data_ptr(), thr.data_ptr(), s0.data_ptr(), out.data_ptr(),
            state.data_ptr(), steps.data_ptr(), t, lanes, *layout, stream)
        outputs, dims = (out, state, steps), (1, 0, 1)
    else:
        p, s, g = (_launchable(a, lanes, 1) for a in args[2:5])
        g_state = _launchable(args[5], lanes, 0)
        dx, dthr, dstate0 = new(t, lanes), new(lanes), new(lanes, 2)
        code = build.library('note_release_bwd').note_release_bwd_launch(
            x.data_ptr(), thr.data_ptr(), p.data_ptr(), s.data_ptr(),
            g.data_ptr(), g_state.data_ptr(), dx.data_ptr(),
            dthr.data_ptr(), dstate0.data_ptr(), t, lanes, *layout, stream)
        outputs, dims = (dx, dthr, dstate0), (1, 0, 0)
    build.check(code, f'{kernel}_launch')
    if lanes == b:
        return outputs
    return tuple(o.narrow(dim, 0, b).contiguous()
                 for o, dim in zip(outputs, dims))


def note_release_scan_cuda(active_pitch: torch.Tensor,
                           threshold: torch.Tensor,
                           state0: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors; raises on anything it does not take."""
    args = _check_inputs('note_release_scan_cuda', active_pitch, threshold,
                         state0)
    t, b, _ = args[0].shape
    outputs = launch_note_release('note_release', args,
                                  note_release_plan('note_release', t, b))
    build.LAUNCHES['note_release'] += 1
    return outputs


def note_release_scan_res_cuda(active_pitch: torch.Tensor,
                               threshold: torch.Tensor,
                               state0: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """K6 (K3 plus the pre-update steps stream) on CUDA tensors."""
    args = _check_inputs('note_release_scan_res_cuda', active_pitch,
                         threshold, state0)
    t, b, _ = args[0].shape
    outputs = launch_note_release(
        'note_release_res', args, note_release_plan('note_release_res', t, b))
    build.LAUNCHES['note_release_res'] += 1
    return outputs


def note_release_scan_bwd_cuda(active_pitch: torch.Tensor,
                               threshold: torch.Tensor,
                               prev: torch.Tensor, steps: torch.Tensor,
                               g_out: torch.Tensor, g_state: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """K7 on CUDA tensors: (dx (T, B), per-lane dthreshold (B,),
    dstate0 (B, 2))."""
    x, thr, gs = _check_inputs('note_release_scan_bwd_cuda', active_pitch,
                               threshold, g_state)
    t, b, _ = x.shape
    streams = [prev, steps, g_out.reshape(t, b)]
    if any(not a.is_cuda or a.dtype != torch.float32
           or tuple(a.shape) != (t, b) for a in streams):
        raise ValueError("note_release_scan_bwd_cuda: prev, steps and g_out "
                         f"must be float32 CUDA tensors of ({t}, {b})")
    p, s, g = (a.detach().contiguous() for a in streams)
    outputs = launch_note_release(
        'note_release_bwd', (x, thr, p, s, g, gs),
        note_release_plan('note_release_bwd', t, b))
    build.LAUNCHES['note_release_bwd'] += 1
    return outputs


class NoteReleaseScan(torch.autograd.Function):
    """K6 forward (saving the steps stream) and K7 backward; on CPU tensors
    their plain versions. Counterpart of gru_pallas.py _note_release_vjp."""

    @staticmethod
    def forward(ctx, active_pitch, threshold, state0):
        if tensor_device(active_pitch, 'note_release_scan') == 'cuda':
            out, final, steps = note_release_scan_res_cuda(
                active_pitch, threshold, state0)
        else:
            out, final, steps = note_release_scan_plain_res(
                active_pitch, threshold, state0)
        ctx.save_for_backward(active_pitch, threshold, state0, out, steps)
        return out, final

    @staticmethod
    def backward(ctx, g_out, g_state):
        active_pitch, threshold, state0, out, steps = ctx.saved_tensors
        # The held note entering each step: the outputs shifted by one.
        prev = torch.cat([state0[None, :, 0], out[:-1, :, 0]],
                         dim=0)[:out.shape[0]]
        bwd = (note_release_scan_bwd_cuda
               if tensor_device(active_pitch, 'note_release_scan') == 'cuda'
               else note_release_scan_plain_bwd)
        dx, dthr, dstate0 = bwd(active_pitch, threshold, prev, steps,
                                g_out.contiguous(), g_state.contiguous())
        # The cross-lane sum outside the kernel (gru_pallas.py:713-715).
        return (dx[..., None], torch.sum(dthr).reshape(threshold.shape),
                dstate0)


def note_release_scan(active_pitch: torch.Tensor, threshold: torch.Tensor,
                      state0: torch.Tensor):
    """Front door for models.sub_modules.NoteRelease (time-major). With
    grad enabled and an input requiring it: the NoteReleaseScan Function
    (K6 + K7 on CUDA). Otherwise K3 for CUDA tensors, the plain version for
    CPU tensors."""
    device = tensor_device(active_pitch, 'note_release_scan')
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (active_pitch, threshold, state0)):
        return NoteReleaseScan.apply(active_pitch, threshold, state0)
    if device == 'cuda':
        return note_release_scan_cuda(active_pitch, threshold, state0)
    return note_release_scan_plain(active_pitch, threshold, state0)
