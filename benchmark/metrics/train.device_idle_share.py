"""Share of the traced training window with no kernel or copy on the card."""
from benchmark.metrics._common import idle_share


def read(run):
    return idle_share(run) if "steps" in run.records else None
