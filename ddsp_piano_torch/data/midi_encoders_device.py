"""Voice allocation on the device: pianoroll -> conditioning with no host
round trip.

Counterpart of ddsp_piano_tpu/data/midi_encoders_jax.py. The front part
(the active keys' pitches, the stable ascending sort that keeps the top
n, the gathers of pitch and velocity) runs as torch operators on the
roll's device; the per-frame state machine runs through
``kernels.voice_allocator.allocate``: K9 on the card, its plain loop on
the CPU.

Exactness, as for the JAX function: every binary (0/1-active) roll gives
the host allocator's conditioning (data/midi_encoders.py), also over
capacity; a non-binary roll, whose key * active products can collide,
gives the JAX function's answer, which may differ from the host's. The
serving entry point binarizes the active channel (models/serving.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ddsp_piano_torch.kernels.voice_allocator import allocate

MIN_PITCH = 21
NUM_KEYS = 88


def top_voices(roll: torch.Tensor, n_synths: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, T, 88, 2) roll -> the n_synths highest active pitches of each
    frame, ascending, and their velocities, each (b, T, n_synths). The
    sort is stable: silent keys tie at 0 and keep their key order, as
    jnp.argsort(stable=True) keeps them (midi_encoders_jax.py:149-153)."""
    active = roll[..., 0]
    keys = torch.arange(MIN_PITCH, MIN_PITCH + NUM_KEYS, dtype=torch.float32,
                        device=roll.device)
    pitched = active * keys
    order = torch.sort(pitched, dim=-1, stable=True).indices[..., -n_synths:]
    return (torch.gather(pitched, -1, order),
            torch.gather(roll[..., 1], -1, order))


def roll_to_conditioning_device(roll: torch.Tensor, n_synths: int = 16
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, T, 88, 2) active/onset-velocity roll -> (conditioning
    (b, T, n_synths, 2), polyphony (b, T)), float32, on the roll's
    device; each row from a fresh allocator state."""
    roll = roll.to(torch.float32)
    if roll.dim() != 4 or tuple(roll.shape[2:]) != (NUM_KEYS, 2):
        raise ValueError(f"roll must be (b, T, {NUM_KEYS}, 2), got "
                         f"{tuple(roll.shape)}")
    pitches, velocity = top_voices(roll, n_synths)
    return allocate(pitches, velocity), roll[..., 0].sum(-1)
