"""The benchmark's traffic generator: seeded piano performances.

One general generator reads every traffic mix (``traffic/<mix>.json``).
A performance is a list of notes (pitch, velocity, onset, offset) and
sustain-pedal presses, drawn with MAESTRO-like statistics:

- the note rate of a row is one of a fixed set of rates spread evenly over
  the mix's ``note_rate`` range; the seed only shuffles which row gets
  which rate, so every seed asks for the same amount of work;
- onsets uniform over the row, pitches normal around ``pitch.mean``
  clipped to the piano's 21-108, velocities uniform over ``velocity``,
  durations log-normal clipped to ``duration``'s bounds;
- the sustain pedal alternates down and up spans drawn from
  ``pedal.down_s`` and ``pedal.up_s``; a note released while it is down
  sounds until it rises or until its pitch is struck again (note_seq's
  rule).

The rasterisation follows note_seq's conventions, as the port's MIDI
reader does: a note is active over frames [floor(on fps), ceil(off fps)),
its onset-velocity channel holds velocity / 127 over its first 32 ms, and
the pedal channels hold CC64-67 / 128 (the sustain pedal's down value is
127).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

MIN_PITCH = 21
NUM_KEYS = 88
ONSET_WINDOW_S = 0.032
PEDAL_DOWN_VALUE = 127


def row_rates(mix: Dict, n_rows: int, rng: np.random.Generator
              ) -> np.ndarray:
    """The note rate (notes a second) of each of ``n_rows`` rows: evenly
    spread over the mix's range, in an order drawn from ``rng``."""
    lo, hi = mix['note_rate']
    return rng.permutation(np.linspace(lo, hi, n_rows))


def _pedal_spans(mix: Dict, seconds: float, rng: np.random.Generator
                 ) -> List[Tuple[float, float]]:
    """(down, up) times of the sustain pedal's presses over the row."""
    spans = []
    t = rng.uniform(0.0, mix['pedal']['up_s'][1])
    while t < seconds:
        down = t
        t += rng.uniform(*mix['pedal']['down_s'])
        spans.append((down, min(t, seconds)))
        t += rng.uniform(*mix['pedal']['up_s'])
    return spans


def _sustained(notes: np.ndarray, spans: List[Tuple[float, float]]
               ) -> np.ndarray:
    """Offsets extended through the pedal: a note released while the
    pedal is down sounds until it rises, cut short by the next onset of
    its pitch. ``notes`` rows are (pitch, velocity, onset, offset)."""
    out = notes.copy()
    for i, (_, _, on, off) in enumerate(notes):
        for down, up in spans:
            if down <= off < up:
                out[i, 3] = up
                break
    for pitch in np.unique(out[:, 0]):
        rows = np.flatnonzero(out[:, 0] == pitch)
        rows = rows[np.argsort(out[rows, 2], kind='stable')]
        for a, b in zip(rows, rows[1:]):
            if out[a, 3] > out[b, 2] and notes[a, 3] <= out[b, 2]:
                out[a, 3] = out[b, 2]
    return out


def performance(mix: Dict, seconds: float, frame_rate: int, rate: float,
                rng: np.random.Generator
                ) -> Tuple[np.ndarray, np.ndarray]:
    """One row: (roll (T, 88, 2) float32 active / onset velocity, pedal
    (T, 4) float32), T = seconds * frame_rate."""
    n_frames = int(round(seconds * frame_rate))
    n_notes = int(round(rate * seconds))
    dur = mix['duration']
    pitches = np.clip(np.rint(rng.normal(mix['pitch']['mean'],
                                         mix['pitch']['sd'], n_notes)),
                      MIN_PITCH, MIN_PITCH + NUM_KEYS - 1)
    velocities = rng.integers(mix['velocity'][0], mix['velocity'][1] + 1,
                              n_notes)
    onsets = rng.uniform(0.0, seconds, n_notes)
    lengths = np.clip(rng.lognormal(np.log(dur['median_s']), dur['sigma'],
                                    n_notes), dur['min_s'], dur['max_s'])
    notes = np.stack([pitches, velocities, onsets, onsets + lengths], -1)
    spans = _pedal_spans(mix, seconds, rng)
    notes = _sustained(notes, spans)

    roll = np.zeros((n_frames, NUM_KEYS, 2), np.float32)
    for pitch, velocity, on, off in notes:
        key = int(pitch) - MIN_PITCH
        start = int(np.floor(on * frame_rate))
        end = max(int(np.ceil(off * frame_rate)), start + 1)
        roll[start:end, key, 0] = 1.0
        onset_end = max(int(np.ceil((on + ONSET_WINDOW_S) * frame_rate)),
                        start + 1)
        roll[start:onset_end, key, 1] = np.float32(velocity / 127.0)
    pedal = np.zeros((n_frames, 4), np.float32)
    for down, up in spans:
        a = int(np.floor(down * frame_rate))
        b = int(np.floor(up * frame_rate))
        pedal[a:b, 0] = np.float32(PEDAL_DOWN_VALUE / 128.0)
    return roll, pedal


def batches(mix: Dict, n_batches: int, frame_rate: int, seed: int,
            stream: int = 0) -> List[Dict[str, np.ndarray]]:
    """``n_batches`` batches of the mix's ``batch`` rows of
    ``seconds_per_row`` seconds: roll (b, T, 88, 2), pedal (b, T, 4) and
    piano_model (b, 1) int32, each row its own performance and piano model
    (the models 0 to piano_models - 1 in equal shares, shuffled). Equal
    (seed, stream) give equal batches."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x7069616E,
                                 int(stream)])
    b = int(mix['batch'])
    n_rows = n_batches * b
    rates = row_rates(mix, n_rows, rng)
    pianos = rng.permutation(np.arange(n_rows) % int(mix['piano_models']))
    out = []
    for i in range(n_batches):
        rows = [performance(mix, float(mix['seconds_per_row']), frame_rate,
                            float(rates[i * b + j]), rng) for j in range(b)]
        out.append({
            'roll': np.stack([r for r, _ in rows]),
            'pedal': np.stack([p for _, p in rows]),
            'piano_model': pianos[i * b:(i + 1) * b, None].astype(np.int32),
        })
    return out
