"""Median over the traced first half's steps of the device ms of the span
``sdiff.notes_encoder``: the notes encoder's forward (12 T5 layers over
2048 note positions a segment)."""
from benchmark.metrics._spans import phase_ms


def read(run):
    return phase_ms(run, "sdiff.notes_encoder")
