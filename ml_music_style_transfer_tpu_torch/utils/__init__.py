"""Support code: structured metrics logging (``logging``), the program's
spans and counters, profiling and NaN debugging (``profiling``)."""
