"""NoteRelease recurrence: the plain PyTorch versions of the port's K3,
K6 and K7 (kernels/note_release.py at the commit that added the
benchmark), with the autograd Function that pairs them; no CUDA launch.
"""

from __future__ import annotations

from typing import Tuple

import torch


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


class NoteReleaseScan(torch.autograd.Function):
    """K6 forward (saving the steps stream) and K7 backward; on CPU tensors
    their plain versions. Counterpart of gru_pallas.py _note_release_vjp."""

    @staticmethod
    def forward(ctx, active_pitch, threshold, state0):
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
        dx, dthr, dstate0 = note_release_scan_plain_bwd(active_pitch, threshold, prev, steps,
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
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (active_pitch, threshold, state0)):
        return NoteReleaseScan.apply(active_pitch, threshold, state0)
    return note_release_scan_plain(active_pitch, threshold, state0)
