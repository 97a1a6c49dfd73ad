"""Median over the traced first half's steps of the device ms of the span
``sdiff.decoder``: the FiLM decoder's forward, its cross-attention over the
notes and context encodings included."""
from benchmark.metrics._spans import phase_ms


def read(run):
    return phase_ms(run, "sdiff.decoder")
