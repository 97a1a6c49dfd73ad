"""Note event tokens: a segment of notes as the MT3-style token sequence that
Spectrogram Diffusion's notes encoder reads (Hawthorne et al. 2022,
arXiv:2206.05408; the codec of MT3, Gardner et al. 2021).

The event vocabulary, in this order, each range inclusive:

  - ``shift`` 0..1000: the time since the segment's start in 10 ms steps
    (100 steps a second, at most 10 s in one token);
  - ``pitch`` 0..127;
  - ``velocity`` 0..1: one velocity bin, 0 for a note-off, 1 for an onset;
  - ``tie`` 0: the end of the tie section;
  - ``program`` 0..127 (General MIDI);
  - ``drum`` 0..127.

A token is its event's index over these ranges plus 3; 0 is padding, 1 the
end of the sequence and 2 unknown, so the codec's 1388 events take tokens
3..1390 of the encoder's 1536.

A segment ``[start, end)`` is encoded as: the tie section, the notes
sounding at ``start`` (begun before it, ending after it) as ``program``
``pitch`` pairs in order of (program, pitch), then ``tie``; then the events
inside the segment in time order, each at its step ``round((t - start) *
100)``: note-offs before onsets at one step, each kind in order of
(program, pitch). Before the first event of a new step comes one ``shift``
token per 1000 steps to reach it (the whole time since ``start``, not since
the last event). An event is ``program``, ``velocity`` and ``pitch``, where
a ``program`` or ``velocity`` equal to the last one written is left out.
Then ``EOS``; the sequence is cut at ``length`` tokens or padded there with
``PAD``.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

PAD, EOS, UNK = 0, 1, 2
N_SPECIAL = 3
STEPS_PER_SECOND = 100
MAX_SHIFT_STEPS = 1000
PROGRAM = 0  # General MIDI's acoustic grand piano: the port renders one instrument a score
RANGES = (("shift", 0, MAX_SHIFT_STEPS), ("pitch", 0, 127), ("velocity", 0, 1), ("tie", 0, 0),
          ("program", 0, 127), ("drum", 0, 127))
N_EVENTS = sum(hi - lo + 1 for _, lo, hi in RANGES)


def _offsets() -> dict[str, tuple[int, int, int]]:
    out, off = {}, 0
    for kind, lo, hi in RANGES:
        out[kind] = (off, lo, hi)
        off += hi - lo + 1
    return out


_OFFSETS = _offsets()


def token(kind: str, value: int) -> int:
    """The token of one event."""
    off, lo, hi = _OFFSETS[kind]
    if not lo <= value <= hi:
        raise ValueError(f"{kind} event {value} outside {lo}..{hi}")
    return N_SPECIAL + off + value - lo


def encode_segment(notes: Iterable, start: float, end: float, length: int = 2048) -> np.ndarray:
    """(length,) int64 tokens of the notes of ``[start, end)`` seconds.

    ``notes`` are objects with ``pitch``, ``velocity`` (1..127), ``start``
    and ``end`` in seconds (``midi.parser.Note``), all played by ``PROGRAM``."""
    notes = sorted(notes, key=lambda n: (n.pitch, n.start))
    out: list[int] = []
    state = {"program": None, "velocity": None}

    def put(kind: str, value: int) -> None:
        if kind in state:
            if state[kind] == value:
                return
            state[kind] = value
        out.append(token(kind, value))

    for n in notes:  # the tie section
        if n.start < start < n.end:
            put("program", PROGRAM)
            put("pitch", n.pitch)
    put("tie", 0)
    events = []  # (step, onset?, pitch)
    for n in notes:
        if start <= n.start < end:
            events.append((_step(n.start - start), 1, n.pitch))
        if start < n.end < end and n.end > n.start:
            events.append((_step(n.end - start), 0, n.pitch))
    at = 0
    for step, onset, pitch in sorted(events):
        if step > at:
            at = step
            for _ in range(step // MAX_SHIFT_STEPS):
                put("shift", MAX_SHIFT_STEPS)
            if step % MAX_SHIFT_STEPS:
                put("shift", step % MAX_SHIFT_STEPS)
        put("program", PROGRAM)
        put("velocity", onset)
        put("pitch", pitch)
    out.append(EOS)
    tokens = np.full(length, PAD, dtype=np.int64)
    n = min(length, len(out))
    tokens[:n] = out[:n]
    return tokens


def _step(seconds: float) -> int:
    return int(round(seconds * STEPS_PER_SECOND))
