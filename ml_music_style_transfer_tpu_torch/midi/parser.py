"""Standard MIDI File (SMF) parser — pure Python, zero dependencies.

The port's own copy of ``ml_music_style_transfer_tpu/midi/parser.py``
(the port imports nothing of the JAX package).

Replaces the reference's use of pretty_midi.PrettyMIDI for note extraction
(reference preprocessing/preprocess.py:146, model/inference.py:40). Parses
format 0/1 files, builds a tempo map, and emits notes with absolute times in
seconds, which feed the piano-roll vectorizer (midi/pianoroll.py).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Note:
    """One note event: pitch 0-127, velocity 1-127, [start, end) in seconds."""

    pitch: int
    velocity: int
    start: float
    end: float


@dataclasses.dataclass
class MidiFile:
    """Parsed MIDI content: notes across all tracks/instruments + tempo map."""

    notes: List[Note]
    tempo_map: List[Tuple[int, int]]  # (tick, microseconds per quarter)
    ticks_per_quarter: int

    @property
    def end_time(self) -> float:
        return max((n.end for n in self.notes), default=0.0)


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    for _ in range(4):  # SMF caps variable-length quantities at 4 bytes
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos
    raise ValueError("variable-length quantity longer than 4 bytes")


class _TempoMap:
    """Tick -> seconds conversion over a piecewise-constant tempo map."""

    def __init__(self, events: List[Tuple[int, int]], tpq: int):
        if not events or events[0][0] != 0:
            events = [(0, 500000)] + events  # SMF default: 120 bpm
        if tpq <= 0:
            raise ValueError("metrical division with 0 ticks per quarter")
        self.tpq = tpq
        # precompute cumulative seconds at each tempo-change tick
        self.ticks = [e[0] for e in events]
        self.tempi = [e[1] for e in events]
        self.times = [0.0]
        for i in range(1, len(events)):
            dt_ticks = self.ticks[i] - self.ticks[i - 1]
            self.times.append(
                self.times[-1] + dt_ticks * self.tempi[i - 1] / (1e6 * tpq)
            )

    def tick_to_time(self, tick: int) -> float:
        # linear scan is fine: tempo maps are tiny
        i = 0
        for j in range(len(self.ticks)):
            if self.ticks[j] <= tick:
                i = j
            else:
                break
        return self.times[i] + (tick - self.ticks[i]) * self.tempi[i] / (1e6 * self.tpq)


class _SmpteMap:
    """Tick -> seconds for SMPTE-division files: absolute time, tempo-free.

    SMF header division with bit 15 set encodes (-fps, ticks_per_frame);
    a tick is 1/(fps*tpf) seconds regardless of tempo meta events
    (which only apply to metrical division). fps code 29 means the NTSC
    drop-frame rate 29.97, matching pretty_midi/mido's convention
    (the reference accepts such files via pretty_midi,
    reference preprocessing/preprocess.py:146)."""

    def __init__(self, division: int):
        fps = 256 - ((division >> 8) & 0xFF)  # two's-complement negative byte
        if fps == 29:
            fps = 29.97
        tpf = division & 0xFF
        if tpf == 0:
            raise ValueError("SMPTE division with 0 ticks per frame")
        self.seconds_per_tick = 1.0 / (fps * tpf)

    def tick_to_time(self, tick: int) -> float:
        return tick * self.seconds_per_tick


def _parse_track(data: bytes) -> Tuple[List[Tuple[int, int, int, int]], List[Tuple[int, int]]]:
    """Parse one MTrk chunk body.

    Returns (note_events, tempo_events) where note_events are
    (tick, kind, pitch, velocity) with kind 1=on, 0=off.
    """
    pos = 0
    tick = 0
    running_status = 0
    notes: List[Tuple[int, int, int, int]] = []
    tempi: List[Tuple[int, int]] = []
    n = len(data)
    while pos < n:
        delta, pos = _read_varlen(data, pos)
        tick += delta
        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running_status = status
        else:
            if not running_status:
                raise ValueError("data byte with no running status")
            status = running_status

        kind = status & 0xF0
        if kind in (0x80, 0x90):
            pitch, vel = data[pos], data[pos + 1]
            pos += 2
            if pitch & 0x80 or vel & 0x80:
                # SMF data bytes are 7-bit; a high bit here means a corrupt
                # stream (a pitch >= 128 would crash the (T, 128) piano-roll
                # scatter downstream with a raw IndexError)
                raise ValueError(
                    f"data byte out of range in note event: {pitch}, {vel}")
            if kind == 0x90 and vel > 0:
                notes.append((tick, 1, pitch, vel))
            else:
                notes.append((tick, 0, pitch, 0))
        elif kind in (0xA0, 0xB0, 0xE0):
            pos += 2
        elif kind in (0xC0, 0xD0):
            pos += 1
        elif status in (0xF0, 0xF7):
            length, pos = _read_varlen(data, pos)
            pos += length
        elif status == 0xFF:
            meta_type = data[pos]
            pos += 1
            length, pos = _read_varlen(data, pos)
            if meta_type == 0x51 and length == 3:
                tempo = int.from_bytes(data[pos : pos + 3], "big")
                tempi.append((tick, tempo))
            pos += length
            if meta_type == 0x2F:
                break
        else:
            raise ValueError(f"unsupported status byte 0x{status:02x}")
    return notes, tempi


def parse_midi_bytes(raw: bytes) -> MidiFile:
    """Parse SMF bytes. Malformed/truncated input raises ValueError (never a
    raw IndexError/struct.error) — serving feeds user-supplied files here
    (reference model/inference.py:40 delegates this robustness to
    pretty_midi; tests/test_midi_fuzz.py pins ours)."""
    try:
        return _parse_midi_bytes(raw)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated or malformed MIDI file: {e}") from e


def _parse_midi_bytes(raw: bytes) -> MidiFile:
    if raw[:4] != b"MThd":
        raise ValueError("not a MIDI file (missing MThd)")
    if len(raw) < 14:
        raise ValueError("truncated MIDI header")
    hlen = struct.unpack(">I", raw[4:8])[0]
    fmt, ntrks, division = struct.unpack(">HHH", raw[8:14])
    if hlen < 6:
        raise ValueError(f"MThd length {hlen} < 6")
    pos = 8 + hlen

    all_note_events: List[List[Tuple[int, int, int, int]]] = []
    tempo_events: List[Tuple[int, int]] = []
    for _ in range(ntrks):
        if raw[pos : pos + 4] != b"MTrk":
            raise ValueError("malformed track chunk")
        tlen = struct.unpack(">I", raw[pos + 4 : pos + 8])[0]
        if pos + 8 + tlen > len(raw):
            raise ValueError("track chunk extends past end of file")
        body = raw[pos + 8 : pos + 8 + tlen]
        pos += 8 + tlen
        notes, tempi = _parse_track(body)
        all_note_events.append(notes)
        tempo_events.extend(tempi)

    tempo_events.sort()
    if division & 0x8000:
        tmap = _SmpteMap(division)
    else:
        tmap = _TempoMap(tempo_events, division)

    notes: List[Note] = []
    for track_events in all_note_events:
        active: dict[int, List[Tuple[int, int]]] = {}
        for tick, kind, pitch, vel in sorted(track_events, key=lambda e: (e[0], e[1])):
            if kind == 1:
                active.setdefault(pitch, []).append((tick, vel))
            else:
                stack = active.get(pitch)
                if stack:
                    start_tick, v = stack.pop(0)
                    s, e = tmap.tick_to_time(start_tick), tmap.tick_to_time(tick)
                    if e > s:
                        notes.append(Note(pitch, v, s, e))
    notes.sort(key=lambda nt: (nt.start, nt.pitch))
    return MidiFile(notes=notes, tempo_map=tempo_events or [(0, 500000)], ticks_per_quarter=division)


def load(path: str) -> MidiFile:
    """Parse a .mid file from disk."""
    with open(path, "rb") as f:
        return parse_midi_bytes(f.read())
