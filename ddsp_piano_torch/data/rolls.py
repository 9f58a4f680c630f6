"""Seeded synthetic pianorolls for the voice allocator's checks.

Each roll is (n_frames, 88, 2) float32: the active channel (0 or 1) and
the onset velocity. ``held_notes_roll`` scatters held notes of random
keys, lengths and onsets; ``churn_roll`` keeps more keys active than
there are voices and changes them every frame, so the allocator's
overflow band is taken throughout.
"""

from __future__ import annotations

import numpy as np


def held_notes_roll(seed: int, n_frames: int, density: int = None
                    ) -> np.ndarray:
    """``density`` notes (10 to 59, drawn, when it is None) of random
    keys, onsets and lengths of 1 to 39 frames."""
    rng = np.random.RandomState(seed)
    roll = np.zeros((n_frames, 88, 2), np.float32)
    density = density or rng.randint(10, 60)
    for _ in range(density):
        p = rng.randint(0, 88)
        s = rng.randint(0, n_frames - 5)
        e = s + rng.randint(1, 40)
        roll[s:e, p, 0] = 1.0
        roll[s, p, 1] = rng.rand()
    return roll


def churn_roll(seed: int, n_synths: int, n_frames: int) -> np.ndarray:
    """A random walk of the active keys, held between n_synths + 1 and
    3 n_synths keys, with up to n_synths - 1 changes a frame."""
    rng = np.random.RandomState(seed)
    roll = np.zeros((n_frames, 88, 2), np.float32)
    lo, hi = n_synths + 1, min(88, 3 * n_synths)
    active = set(rng.choice(88, rng.randint(lo, hi), replace=False))
    for t in range(n_frames):
        for _ in range(rng.randint(0, n_synths)):
            if len(active) > lo and rng.rand() < 0.5:
                active.discard(rng.choice(sorted(active)))
            elif len(active) < hi:
                k = rng.randint(0, 88)
                if k not in active:
                    active.add(k)
                    roll[t, k, 1] = rng.rand()
        roll[t, sorted(active), 0] = 1.0
    return roll
