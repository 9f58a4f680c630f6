"""Voice allocation state machine: a CUDA kernel (csrc/voice_allocator.cu)
and its plain PyTorch version.

Counterpart of the ``lax.scan`` over ``_frame_step`` in
ddsp_piano_tpu/data/midi_encoders_jax.py (:45-131, :155-158). There is no
Pallas kernel at that site: on the TPU the scan is one XLA loop. Eagerly,
the plain version issues some 40-50 small operators a frame, so on the
card the scan is one call of K9.

Per batch row, the state is the pitch held by each slot (``assigned``),
the round-robin ``cursor`` (-1 when the table is full), the last frame's
permutation (``reorder``) and whether a frame was seen (``started``).
Each frame takes the top-n active pitches (ascending, silent entries 0)
and their velocities, and writes them permuted into the slots:
``(pitch, velocity)[reorder]``. The comparisons are exact (pitches are
small integers in float32, or whatever key * active products a
non-binary roll gives), so the kernel and the plain version agree bit for
bit on every input.

K9 walks only some frames. A frame whose pitches equal the previous
frame's entry by entry, when the table mirrors the previous frame (every
entry's pitch is some slot's note and every slot's note some entry's
pitch, as after any fast frame), takes the fast path too and changes
nothing, so the kernel skips it: it classifies
the frames in parallel (a bitmask of frames equal to their predecessor),
walks the rest a warp a row with the next walked frames' pitches already
in shared memory, and fills every frame in parallel with the permutation
of the last walked frame at or before it. On demo.mid's 10 s (2625 frames
at 16 voices) it walks a few dozen frames. Its bound is that walk's chain
of dependent operations (csrc/voice_allocator.cu); ``allocate_plain(...,
return_fast=True)`` counts the frames a roll takes on the fast path and
those the walk skips.
"""

from __future__ import annotations

import torch

from ddsp_piano_torch.device import tensor_device
from ddsp_piano_torch.kernels import build

# One warp a batch row, a lane a voice slot (csrc/voice_allocator.cu).
MAX_VOICES = 32


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim``; 0 where there is none (the
    argmax of an all-False row, as jnp.argmax gives it)."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, device=mask.device).view(shape)
    first = torch.where(mask, idx, n).amin(dim)
    return torch.where(first == n, 0, first)


def _last_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the last True along ``dim`` (-1 where there is none): the
    update that wins a scatter with repeated indices, as XLA applies
    them in order."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, device=mask.device).view(shape)
    return torch.where(mask, idx, -1).amax(dim)


def mirrors(assigned: torch.Tensor, pitches: torch.Tensor) -> torch.Tensor:
    """(b,) whether each row's table (b, n) mirrors its frame's pitches
    (b, n): every entry's pitch is some slot's note and every slot's note
    some entry's pitch (float ==): _frame_step's fast test, once a frame
    was seen."""
    eq = pitches[:, :, None] == assigned[:, None, :]
    return eq.any(2).all(1) & eq.any(1).all(1)


def _frame_step(state, pitches, velocity):
    """One frame of midi_encoders_jax._frame_step for b rows at once:
    state (assigned (b, n) f32, cursor (b,) i64, reorder (b, n) i64,
    started (b,) bool), pitches and velocity (b, n) -> (new state,
    (pitch, velocity) each (b, n), fast (b,) bool: the rows that took
    the fast path)."""
    assigned, cursor, reorder, started = state
    n = pitches.shape[1]
    idx = torch.arange(n, device=pitches.device)

    # Fast path: the same note set as the table -> the same permutation.
    fast = mirrors(assigned, pitches) & started

    # Release: slots whose note is gone.
    keep = (pitches[:, :, None] == assigned[:, None, :]).any(1)  # (b, s)
    released = (assigned != 0) & ~keep
    assigned_rel = torch.where(keep, assigned, 0.0)
    cursor_rel = torch.where((cursor < 0) & released.any(1),
                             _first_true(released, 1), cursor)

    # Sustained notes keep their slots.
    match = ((assigned_rel[:, :, None] == pitches[:, None, :])
             & (pitches != 0)[:, None, :])                      # (b, s, c)
    reorder_new = torch.where(match.any(2), _first_true(match, 2), 0)

    # Free slots in ring order from the cursor: rank[s].
    free = assigned_rel == 0.0
    start = cursor_rel.clamp(min=0)
    ring_pos = torch.where(free, (idx[None, :] - start[:, None]) % n, n + 1)
    rank = ((ring_pos[:, None, :] < ring_pos[:, :, None])
            & free[:, None, :]).sum(2)                          # (b, s)

    # New notes take ranks 0..m-1, silent entries the ranks after them.
    is_new = ~(pitches[:, :, None] == assigned_rel[:, None, :]).any(2)
    n_new = is_new.sum(1, keepdim=True)
    is_zero = pitches == 0.0
    new_order = torch.cumsum(is_new.long(), 1) - 1
    zero_order = torch.cumsum((is_zero & ~is_new).long(), 1) - 1 + n_new
    want_rank = torch.where(is_new, new_order,
                            torch.where(is_zero, zero_order, -1))
    n_free = free.sum(1, keepdim=True)
    slot_of_rank = _first_true((rank[:, None, :] == idx[None, :, None])
                               & free[:, None, :], 2)           # (b, r)
    # Beyond the free count: the last slot (the overflow clamp).
    target = torch.where(
        want_rank < n_free,
        slot_of_rank.gather(1, want_rank.clamp(0, n - 1)), n - 1)
    assign_mask = want_rank >= 0
    hit = (target[:, :, None] == idx) & assign_mask[:, :, None]  # (b, c, s)
    reorder_new = torch.where(hit.any(1), _last_true(hit, 1), reorder_new)
    placed = hit & (is_new & ~is_zero)[:, :, None]
    assigned_new = torch.where(
        placed.any(1), pitches.gather(1, _last_true(placed, 1).clamp(min=0)),
        assigned_rel)

    # Cursor: the first silent-filled slot in ring order, or -1 (full).
    z = (is_zero & assign_mask & (want_rank < n_free)).sum(1)
    cursor_new = torch.where(
        z > 0, slot_of_rank.gather(1, n_new.clamp(0, n - 1))[:, 0], -1)

    col = fast[:, None]
    assigned = torch.where(col, assigned, assigned_new)
    cursor = torch.where(fast, cursor, cursor_new)
    reorder = torch.where(col, reorder, reorder_new)
    started = torch.ones_like(started)
    return ((assigned, cursor, reorder, started),
            (pitches.gather(1, reorder), velocity.gather(1, reorder)), fast)


def allocate_plain(pitches: torch.Tensor, velocity: torch.Tensor,
                   return_fast: bool = False):
    """(b, T, n) ascending top-n pitches and their velocities ->
    (b, T, n, 2) conditioning, a loop over frames from a fresh state;
    with ``return_fast``, also each row's count of frames on the fast
    path (b,) and of the frames K9's walk skips (b,): those whose
    pitches equal the previous frame's entry by entry, when the table
    mirrors the previous frame (the work a call of K9 does depends on
    both)."""
    b, t, n = pitches.shape
    dev = pitches.device
    state = (torch.zeros(b, n, device=dev),
             torch.zeros(b, dtype=torch.long, device=dev),
             torch.arange(n, device=dev).expand(b, n),
             torch.zeros(b, dtype=torch.bool, device=dev))
    out = pitches.new_empty(b, t, n, 2)
    n_fast = torch.zeros(b, dtype=torch.long, device=dev)
    n_skipped = torch.zeros(b, dtype=torch.long, device=dev)
    mirror = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(t):
        if return_fast and i:
            n_skipped += mirror & (pitches[:, i] == pitches[:, i - 1]).all(1)
        state, (p, v), fast = _frame_step(state, pitches[:, i],
                                          velocity[:, i])
        out[:, i, :, 0] = p
        out[:, i, :, 1] = v
        if return_fast:
            n_fast += fast
            mirror = mirrors(state[0], pitches[:, i])
    return (out, n_fast, n_skipped) if return_fast else out


def _check_inputs(pitches: torch.Tensor, velocity: torch.Tensor):
    if pitches.dim() != 3 or tuple(velocity.shape) != tuple(pitches.shape):
        raise ValueError("pitches and velocity must both be (b, T, n); got "
                         f"{tuple(pitches.shape)}, {tuple(velocity.shape)}")
    n = pitches.shape[2]
    if not 1 <= n <= MAX_VOICES:
        raise ValueError(f"allocate_cuda takes 1 to {MAX_VOICES} voices "
                         f"(a lane each), got {n}")
    if any(not a.is_cuda or a.dtype != torch.float32
           for a in (pitches, velocity)):
        raise ValueError("allocate_cuda takes float32 CUDA tensors")
    return pitches.contiguous(), velocity.contiguous()


def allocate_cuda(pitches: torch.Tensor,
                  velocity: torch.Tensor) -> torch.Tensor:
    """K9 on CUDA tensors (its three kernels, one count); raises on
    anything it does not take."""
    pitches, velocity = _check_inputs(pitches, velocity)
    b, t, n = pitches.shape
    dev = pitches.device
    out = torch.empty(b, t, n, 2, dtype=torch.float32, device=dev)
    if b and t:
        # Scratch: the classify stage's bitmask (a 32-bit word per 32
        # frames) and each word's anchor, the walked frames' permutations.
        words = -(-t // 32)
        same = torch.empty(b, words, dtype=torch.int32, device=dev)
        anchor = torch.empty(b, words, dtype=torch.int32, device=dev)
        perm = torch.empty(b, t, n, dtype=torch.int8, device=dev)
        with torch.cuda.device(dev):
            code = build.library('voice_allocator').voice_allocator_launch(
                pitches.data_ptr(), velocity.data_ptr(), out.data_ptr(),
                same.data_ptr(), anchor.data_ptr(), perm.data_ptr(), b, t,
                n, build.stream_handle(dev))
        build.check(code, 'voice_allocator_launch')
        build.LAUNCHES['voice_allocator'] += 1
    return out


def allocate(pitches: torch.Tensor, velocity: torch.Tensor) -> torch.Tensor:
    """Front door: K9 for CUDA tensors, the plain loop for CPU tensors."""
    if tensor_device(pitches, 'allocate') == 'cuda':
        return allocate_cuda(pitches, velocity)
    return allocate_plain(pitches, velocity)
