"""Median over the traced first half's steps of the device ms of the span
``train.loss``: the loss on the prediction (L1, or the autoencoder's
multi-scale mel loss)."""
from benchmark.metrics._spans import phase_ms


def read(run):
    return phase_ms(run, "train.loss")
