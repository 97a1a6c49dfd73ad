"""MIDI subsystem: SMF parse/write + piano-roll vectorization (no deps)."""
from . import parser, writer, pianoroll  # noqa: F401
from .parser import Note, MidiFile, load  # noqa: F401
