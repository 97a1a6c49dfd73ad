"""Standard MIDI File writer — pure Python, zero dependencies.

The port's own copy of ``ml_music_style_transfer_tpu/midi/writer.py``.

Used by the debug-alignment path (the reference writes piano-roll chunks back
to .mid so a human can listen: preprocessing/utils/io_manager.py:31-36 via
pretty_midi_roll_to_midi.py) and by the synthetic-data generator for tests.
Writes single-track format-0 files at a fixed tempo.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

from .parser import Note

_DEFAULT_TEMPO = 500000  # microseconds per quarter (120 bpm)
_DEFAULT_TPQ = 480


def _varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def write_midi_bytes(
    notes: Iterable[Note],
    tempo: int = _DEFAULT_TEMPO,
    ticks_per_quarter: int = _DEFAULT_TPQ,
    program: int = 0,
) -> bytes:
    def to_tick(t: float) -> int:
        return max(0, int(round(t * 1e6 * ticks_per_quarter / tempo)))

    events: List[Tuple[int, int, int, int]] = []  # (tick, order, status, ...)
    for n in notes:
        events.append((to_tick(n.start), 1, 0x90, n.pitch, max(1, min(127, n.velocity))))
        events.append((to_tick(n.end), 0, 0x80, n.pitch, 0))
    # note-offs sort before note-ons at the same tick (order key) so
    # back-to-back same-pitch notes re-trigger correctly
    events.sort(key=lambda e: (e[0], e[1]))

    body = bytearray()
    # tempo meta
    body += _varlen(0) + bytes([0xFF, 0x51, 0x03]) + tempo.to_bytes(3, "big")
    # program change
    body += _varlen(0) + bytes([0xC0, program & 0x7F])
    last_tick = 0
    for tick, _, status, pitch, vel in events:
        body += _varlen(tick - last_tick) + bytes([status, pitch & 0x7F, vel & 0x7F])
        last_tick = tick
    body += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    header = b"MThd" + (6).to_bytes(4, "big") + (0).to_bytes(2, "big")
    header += (1).to_bytes(2, "big") + ticks_per_quarter.to_bytes(2, "big")
    track = b"MTrk" + len(body).to_bytes(4, "big") + bytes(body)
    return header + track


def save(path: str, notes: Iterable[Note], **kwargs) -> None:
    with open(path, "wb") as f:
        f.write(write_midi_bytes(notes, **kwargs))
