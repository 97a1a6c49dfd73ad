#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` the
per-layer metrics and ``breakdown``, and last ``checks``: each number
compared with the reference beside its limit, also the last lines of
standard error). Without a card, or with fewer than the cell asks for, it
exits with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.keep_caches_in_checkout()
    sys.exit(harness.main(t_start=T_START))
