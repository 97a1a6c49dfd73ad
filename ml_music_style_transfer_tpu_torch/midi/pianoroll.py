"""Piano-roll vectorization: notes -> binarized roll + onset/offset matrices.

The port's own copy of ``ml_music_style_transfer_tpu/midi/pianoroll.py``.

Reimplements the reference's MIDI vectorization (preprocessing/preprocess.py:
139-160 and the duplicate at model/inference.py:40-49):
  - pretty_midi.get_piano_roll(fs).T -> (T, 128) roll, columns
    [int(start*fs), int(end*fs)) per note (velocity-summed)
  - binarize: roll[nonzero] = 1 (preprocess.py:148)
  - onset/offset matrix in {-1, 0, +1}: frame 0 onsets = +1; thereafter +1
    where a pitch newly appears and -1 where it disappears
    (preprocess.py:150-155) — here vectorized as a frame diff instead of the
    reference's O(T) Python loop with np.setdiff1d.

Also provides the inverse (roll -> notes) used by the debug listen-back path
(reference preprocessing/utils/pretty_midi_roll_to_midi.py:17-66).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .parser import Note

N_PITCHES = 128


def notes_to_pianoroll(
    notes: Sequence[Note], fs: int, length: int | None = None
) -> np.ndarray:
    """Notes -> (T, 128) velocity roll, pretty_midi.get_piano_roll semantics.

    ``length`` overrides the roll length (frames); default is
    ceil(end_time * fs), matching pretty_midi's np.arange(0, end, 1/fs) grid.
    """
    end_time = max((n.end for n in notes), default=0.0)
    if length is None:
        length = int(np.ceil(end_time * fs - 1e-9))
    roll = np.zeros((length, N_PITCHES), dtype=np.float64)
    for n in notes:
        s = int(n.start * fs)
        e = int(n.end * fs)
        if e <= s or s >= length:
            continue
        roll[s : min(e, length), n.pitch] += n.velocity
    return roll


def binarize(roll: np.ndarray) -> np.ndarray:
    """roll[nonzero] = 1 (reference preprocess.py:148)."""
    return (roll != 0).astype(roll.dtype)


def onset_offset(binary_roll: np.ndarray) -> np.ndarray:
    """Vectorized onset/offset matrix, exactly matching the reference loop.

    For frame 0, onsets (+1) where the roll is nonzero (preprocess.py:151-152);
    for frame i>0, +1 where a pitch turns on, -1 where it turns off
    (preprocess.py:154-155). Shape (T, 128), values in {-1, 0, +1}.
    """
    active = binary_roll != 0
    prev = np.zeros_like(active)
    prev[1:] = active[:-1]
    onoff = np.zeros(binary_roll.shape, dtype=binary_roll.dtype)
    onoff[active & ~prev] = 1.0
    onoff[~active & prev] = -1.0
    return onoff


def vectorize_notes(notes: Sequence[Note], fs: int, length: int | None = None):
    """Full reference path: notes -> (binarized roll, onoff), both (T, 128)."""
    roll = binarize(notes_to_pianoroll(notes, fs, length))
    return roll, onset_offset(roll)


def pianoroll_to_notes(
    roll: np.ndarray, fs: int, velocity: int = 127
) -> List[Note]:
    """(T, 128) roll -> notes; inverse of notes_to_pianoroll.

    Matches the semantics of the reference's reverse-pianoroll debug path
    (pretty_midi_roll_to_midi.py:17-66): velocity changes delimit notes.
    """
    padded = np.zeros((roll.shape[0] + 2, N_PITCHES), dtype=roll.dtype)
    padded[1:-1] = roll
    changes = np.diff((padded != 0).astype(np.int8), axis=0)
    notes: List[Note] = []
    for pitch in range(N_PITCHES):
        col = changes[:, pitch]
        onsets = np.flatnonzero(col == 1)
        offsets = np.flatnonzero(col == -1)
        for s, e in zip(onsets, offsets):
            v = roll[s, pitch]
            vel = int(v * velocity) if v <= 1.0 else int(v)
            # half-frame offset keeps int(t*fs) exact under float division
            # (frame boundaries like 103/172*172 otherwise floor to 102)
            notes.append(Note(pitch, max(1, min(127, vel)), (s + 0.5) / fs, (e + 0.5) / fs))
    notes.sort(key=lambda n: (n.start, n.pitch))
    return notes
