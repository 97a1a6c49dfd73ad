"""The benchmark of the PyTorch/CUDA port (``ml_music_style_transfer_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
result line. Everything that belongs to one configuration, traffic mix or
per-layer metric is a file found by its name: ``configs/<config>.json``,
``traffic/<mix>.json`` (which names its driver, ``drivers/<driver>.py``) and
``metrics/<metric>.py``. ``reference/`` is the plain PyTorch/NumPy yardstick
that decides ``correct``; it imports nothing of the port.
"""
