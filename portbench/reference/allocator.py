"""Voice allocation: 88-key pianoroll -> n_synths monophonic channels.

A frozen copy of the port's numpy allocator loop (the semantics the
port's CUDA allocator and its C++ host allocator are held to): sustained
notes keep their channel, new notes go to the next free channel under a
round-robin cursor, frames whose note set is unchanged reuse the previous
permutation, and over capacity the cursor degenerates to the last channel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def roll_to_conditioning(roll: np.ndarray, n_synths: int = 16
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(n_frames, 88, 2) active (0/1) and onset-velocity roll ->
    (conditioning (n_frames, n_synths, 2) float32, polyphony (n_frames,)),
    from a fresh allocator state."""
    return MIDIRoll2Conditioning(n_synths)(roll)


class MIDIRoll2Conditioning:
    """Stateful pianoroll -> polyphonic-conditioning converter."""

    def __init__(self, n_synths: int = 16):
        self.n_synths = n_synths
        self.pitch_mul = np.arange(21, 21 + 88)
        self.reorder = np.arange(n_synths)
        self.assigner = 0
        self.assigned_pitch = np.zeros(n_synths)

    def _advance_assigner(self):
        self.assigner = (self.assigner + 1) % self.n_synths
        if 0 not in self.assigned_pitch:
            self.assigner = -1
        else:
            while self.assigned_pitch[self.assigner] != 0:
                self.assigner = (self.assigner + 1) % self.n_synths

    def __call__(self, roll: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Convert stacked active/onset rolls to conditioning.

        Args:
            roll: (n_frames, 88, 2) active (0/1) and onset-velocity rolls.
        Returns:
            conditioning: (n_frames, n_synths, 2) per-channel pitch and
                onset velocity.
            polyphony: (n_frames,) simultaneous-note count of the input roll.
        """
        n = self.n_synths
        active = roll[..., 0].astype(np.float64).copy()
        polyphony = np.sum(active, axis=-1)
        pitched = active * self.pitch_mul

        # Top-n pitches per frame, ascending (zeros fill unused slots).
        # kind='stable' pins the order of tied zero-pitch keys. (The
        # reference's default quicksort tie order is an unspecified
        # implementation detail; ties only decide which silent key's
        # velocity fills unused slots, never the channel assignment of
        # sounding notes.)
        idxs = np.argsort(pitched, axis=-1, kind='stable')[:, -n:]
        pitches_all = np.take_along_axis(pitched, idxs, axis=-1)
        velocity_all = np.take_along_axis(roll[..., 1], idxs, axis=-1)

        out_pitch = np.zeros_like(pitches_all)
        out_vel = np.zeros_like(velocity_all)

        for t in range(pitches_all.shape[0]):
            pitches = pitches_all[t]

            # Fast path: identical note set -> reuse previous permutation.
            common = np.intersect1d(pitches, self.assigned_pitch)
            if (t > 0
                    and len(common) == len(np.unique(pitches))
                    and len(common) == len(np.unique(self.assigned_pitch))):
                out_pitch[t] = np.take(pitches, self.reorder)
                out_vel[t] = np.take(velocity_all[t], self.reorder)
                continue

            reorder = np.zeros(n, dtype=int)
            # Release channels whose note ended.
            for c in range(n):
                if self.assigned_pitch[c] not in pitches:
                    self.assigned_pitch[c] = 0
                    if self.assigner == -1:
                        self._advance_assigner()
            # Sustained notes keep their channel.
            for c in range(n):
                if pitches[c] in self.assigned_pitch and pitches[c] != 0:
                    target = np.where(
                        self.assigned_pitch == pitches[c])[0][0]
                    reorder[target] = c
            # New notes to free channels (round-robin).
            for c in range(n):
                if pitches[c] not in self.assigned_pitch:
                    reorder[self.assigner] = c
                    self.assigned_pitch[self.assigner] = pitches[c]
                    self._advance_assigner()
            # Remaining silent slots.
            for c in range(n):
                if pitches[c] == 0:
                    reorder[self.assigner] = c
                    self._advance_assigner()

            out_pitch[t] = np.take(pitches, reorder)
            out_vel[t] = np.take(velocity_all[t], reorder)
            self.reorder = reorder

        conditioning = np.stack([out_pitch, out_vel], axis=-1)
        return conditioning.astype(np.float32), polyphony
