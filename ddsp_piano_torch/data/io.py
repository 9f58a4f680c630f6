"""MIDI and audio files -> model features (numpy, host side).

Counterpart of ddsp_piano_tpu/data/io.py:18-98: load_data and its
helpers copied; load_midi_as_conditioning split into load_midi_as_roll
(the frames before voice allocation, which the CSV CLI allocates on the
device) and the host allocation of that roll.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ddsp_piano_torch.data import audio_io, midi
from ddsp_piano_torch.data.midi_encoders import roll_to_conditioning


def ensure_sequence_length(sequence: np.ndarray, length: int,
                           right: bool = True) -> np.ndarray:
    """Zero-pad or crop axis 0 to `length` (pad/crop at the end if right)."""
    original = sequence.shape[0]
    if original == length:
        return sequence
    if original > length:
        return sequence[:length] if right else sequence[-length:]
    pad = [(0, length - original)] if right else [(length - original, 0)]
    pad += [(0, 0)] * (sequence.ndim - 1)
    return np.pad(sequence, pad)


def load_midi_as_note_sequence(mid_path: str) -> midi.MidiSequence:
    return midi.apply_sustain_control_changes(midi.parse_midi(mid_path))


def midi_roll_from_sequence(note_sequence: midi.MidiSequence,
                            frame_rate: int = 250):
    """(n_frames, 88, 2) active/onset roll + (n_frames, 4) pedals."""
    roll = midi.sequence_to_pianoroll(note_sequence,
                                      frames_per_second=frame_rate,
                                      min_pitch=21, max_pitch=108)
    midi_roll = np.stack([roll.active, roll.onset_velocities], axis=-1)
    pedals = roll.control_changes[:, 64:68].astype(np.float32) / 128.0
    return midi_roll, pedals


def load_midi_as_roll(mid_path: str, frame_rate: int = 250,
                      duration: Optional[float] = None,
                      warm_up_duration: float = 0.0
                      ) -> Dict[str, np.ndarray]:
    """MIDI file -> the roll (1, n_frames, 88, 2) and pedal (1, n_frames,
    4) of load_midi_as_conditioning before voice allocation (the same
    frames: cropped or padded to ``duration``, warm-up silence prepended),
    and the total duration in seconds. The warm-up's silent frames leave a
    voice allocator as it starts, so allocating the whole roll equals
    allocating the cropped one and prepending silence, as ddsp_piano_tpu/
    data/io.py:45-72 does."""
    note_sequence = load_midi_as_note_sequence(mid_path)
    midi_roll, pedals = midi_roll_from_sequence(note_sequence, frame_rate)
    if duration is None:
        n_frames = int(np.ceil(note_sequence.total_time) * frame_rate)
    else:
        n_frames = int(duration * frame_rate)
    total = n_frames + int(warm_up_duration * frame_rate)
    midi_roll, pedals = (
        ensure_sequence_length(ensure_sequence_length(x, n_frames), total,
                               right=False) for x in (midi_roll, pedals))
    return {'roll': midi_roll[np.newaxis].astype(np.float32),
            'pedal': pedals[np.newaxis].astype(np.float32),
            'duration': n_frames / frame_rate + warm_up_duration}


def load_midi_as_conditioning(mid_path: str,
                              n_synths: int = 16,
                              frame_rate: int = 250,
                              duration: Optional[float] = None,
                              warm_up_duration: float = 0.0
                              ) -> Dict[str, np.ndarray]:
    """MIDI file -> conditioning (1, n_frames, n_synths, 2), pedal
    (1, n_frames, 4) and the total duration in seconds (warm-up silence
    prepended): load_midi_as_roll's roll through the host allocator."""
    inputs = load_midi_as_roll(mid_path, frame_rate=frame_rate,
                               duration=duration,
                               warm_up_duration=warm_up_duration)
    conditioning, _ = roll_to_conditioning(inputs['roll'][0], n_synths)
    return {'conditioning': conditioning[np.newaxis].astype(np.float32),
            'pedal': inputs['pedal'], 'duration': inputs['duration']}


def load_data(audio_path: str,
              mid_path: str,
              max_polyphony: Optional[int] = None,
              sample_rate: int = 16000,
              frame_rate: int = 250):
    """Aligned audio + MIDI features for one track: (audio, conditioning,
    pedals, polyphony) with max_polyphony, else (audio, midi roll,
    pedals)."""
    audio = audio_io.load_audio_as_signal(audio_path, sample_rate)
    note_sequence = load_midi_as_note_sequence(mid_path)
    midi_roll, pedals = midi_roll_from_sequence(note_sequence, frame_rate)
    if max_polyphony is not None:
        conditioning, polyphony = roll_to_conditioning(midi_roll,
                                                       max_polyphony)
        return audio, conditioning, pedals, polyphony
    return audio, midi_roll, pedals
