"""Seeded synthetic pianorolls for the voice allocator's checks.

Each roll is (n_frames, 88, 2) float32: the active channel (0 or 1) and
the onset velocity. ``held_notes_roll`` scatters held notes of random
keys, lengths and onsets; ``churn_roll`` keeps more keys active than
there are voices and changes them every frame, so the allocator's
overflow band is taken throughout. ``odd_voices`` skips the roll and the
sort: it gives the allocator unsorted frames with repeated pitches, 0.0,
-0.0 and NaN, held over runs of frames.
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


def odd_voices(seed: int, n_rows: int, n_frames: int, n_voices: int):
    """(pitches, velocity), each (n_rows, n_frames, n_voices) float32:
    frames that repeat the one before with probability 0.7 and otherwise
    change 1 to 3 entries, drawn from six pitches (so repeated ones), 0.0,
    -0.0 and, rarely, NaN. The allocator then meets duplicate pitches, the
    overflow clamp, signed zeros and NaN (equal to nothing), and a frame
    equal to its predecessor after a slow frame whose table need not
    mirror it."""
    rng = np.random.RandomState(seed)
    values = np.float32([60, 62, 64, 65, 67, 69, 0.0, -0.0, np.nan])
    weights = np.array([0.1] * 6 + [0.25, 0.12, 0.03])
    pitches = np.empty((n_rows, n_frames, n_voices), np.float32)
    for r in range(n_rows):
        frame = rng.choice(values, n_voices, p=weights)
        for t in range(n_frames):
            if t and rng.rand() >= 0.7:
                frame = frame.copy()
                k = rng.randint(1, 4)
                frame[rng.randint(0, n_voices, k)] = rng.choice(
                    values, k, p=weights)
            pitches[r, t] = frame
    velocity = rng.rand(n_rows, n_frames, n_voices).astype(np.float32)
    return pitches, velocity
