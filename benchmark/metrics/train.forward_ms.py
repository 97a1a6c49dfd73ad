"""Median over the traced first half's steps of the device ms of the span
``train.forward``: the model's forward."""
from benchmark.metrics._spans import phase_ms


def read(run):
    return phase_ms(run, "train.forward")
