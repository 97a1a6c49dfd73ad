"""Share (%) of the notes encoder's positions that held padding over the
traced first half's steps: 1 - the sum of the ``train.step`` spans'
``notes_tokens`` counters over the sum of their ``notes_positions`` (the
positions the program computed). None where no step counted a position,
as in a program without the counters."""
from benchmark.metrics._spans import first_steps


def read(run):
    steps = first_steps(run)
    if steps is None:
        return None
    counted = [r.counters for recs in steps.values() for r in recs
               if r.name == "train.step" and r.counters.get("notes_positions")]
    if not counted:
        return None
    positions = sum(c["notes_positions"] for c in counted)
    return 100.0 * (1.0 - sum(c.get("notes_tokens", 0) for c in counted) / positions)
