"""Support code: structured metrics logging (``logging``), profiling, step
timing and NaN debugging (``profiling``)."""
