"""Median over the traced first half's steps of the device ms of the span
``train.input``: the batch made ready on the card, the store's gather and
the STFT of 2B rows (``DeviceDataStore.local_batch``), or the
autoencoder's mel projection."""
from benchmark.metrics._spans import phase_ms


def read(run):
    return phase_ms(run, "train.input")
