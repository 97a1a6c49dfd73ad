"""Mean over the traced first half's steps of the caching allocator's
``cudaMalloc`` and ``cudaFree`` calls while the step's ``train.step`` span
was open (its ``allocator_calls`` counter)."""
from benchmark.metrics._spans import first_steps


def read(run):
    steps = first_steps(run)
    if steps is None:
        return None
    calls = [r.counters["allocator_calls"] for recs in steps.values() for r in recs
             if r.name == "train.step" and "allocator_calls" in r.counters]
    return sum(calls) / len(calls) if calls else None
