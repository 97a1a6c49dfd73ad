"""Host seconds of the set-up span ``setup.library``: the operator
library's build check (or build) and its load."""
from benchmark.metrics._spans import setup_s


def read(run):
    return setup_s(run, "setup.library")
