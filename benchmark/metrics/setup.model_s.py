"""Host seconds of the set-up span ``setup.model``: the model built and
initialised and its optimizer made (``Trainer.__init__`` and
``init_state``; ``SpectrogramAutoencoder`` and its train step's Adam)."""
from benchmark.metrics._spans import setup_s


def read(run):
    return setup_s(run, "setup.model")
