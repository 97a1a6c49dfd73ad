"""One reader per per-layer metric: ``<metric name>.py`` with
``read(run) -> float | None``, loaded by file name (``harness.metric_reader``)."""
