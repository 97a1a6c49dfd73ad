"""MIDI subsystem: SMF parse/write, piano-roll vectorization and note event
tokens (no deps)."""
from . import events, parser, writer, pianoroll  # noqa: F401
from .parser import Note, MidiFile, load  # noqa: F401
