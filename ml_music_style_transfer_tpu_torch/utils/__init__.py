"""Support code: structured metrics logging."""
