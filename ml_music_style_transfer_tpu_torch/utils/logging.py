"""Structured metrics logging (the JAX package's ``utils/logging.py``).

The reference logs with prints and dumps loss lists into hyperparams.json
(model/train.py:145-148,207-208); ``fit`` adds a JSONL stream, one record
per event, that tools can tail.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsLogger:
    """Append-only JSONL metrics writer."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
