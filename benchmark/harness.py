"""One run of one cell: find its files by name, check the card, hand the
run to the traffic mix's driver, read the metrics, judge ``correct`` and
print the result line.

A driver module (``drivers/<name>.py``) has ``run(ctx) -> dict`` that sets
the program up, calls ``ctx.open_window()`` when set-up ends, measures for
``ctx.seconds`` (calling ``ctx.tracer.poll()`` often: it starts the
profiler of a traced run near the window's end), calls
``ctx.close_window()``, reads the memory peak, frees the program's state
and compares what it produced with the reference. It returns::

    {"attempted": int, "failed": int, "metrics": {end-to-end name: value},
     "records": {...}, "checks": {name: (value, limit)},
     "memory_peak_bytes": int}

A per-layer metric is ``metrics/<name>.py`` with ``read(run) -> float | None``
(``run.records``, ``run.trace``: ``trace.Summary`` or None, ``run.config``,
``run.traffic``); None leaves the metric out of the line. A reader that
takes a rate or latency from the records takes it from before
``run.trace.t0``, where the profiler started.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules whose presence after the window means the port loaded JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_music_style_transfer_tpu")


class CellError(RuntimeError):
    """The run cannot give a result (no card, unknown cell, JAX loaded)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration entry, configuration file) of ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise CellError(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, entry, load_json(os.path.join(ROOT, entry["file"]))


def traffic_file(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, kind: str, workload: str) -> list[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") this cell reports."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise CellError("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise CellError(f"the cell needs {n} cards, {torch.cuda.device_count()} visible")


def keep_caches_in_checkout() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv=None, t_start: float | None = None, test: dict | None = None) -> dict:
    """One run; returns the result line's object (``correct`` and all).

    ``test`` is the CPU test hook: {"device": "cpu", "config": {...},
    "traffic": {...}} overrides merged into the files, and no card is
    asked for. Runs on the card never pass it."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, entry, config = find_cell(spec, args.workload)
    traffic = traffic_file(cell["traffic"])
    if test is None:
        require_cards(cell["chips"])
        device = "cuda"
    else:
        device = test["device"]
        config = {**config, **test.get("config", {})}
        traffic = {**traffic, **test.get("traffic", {})}
    import torch

    from . import trace as trace_mod

    tracer = trace_mod.Tracer(bool(args.trace), float(traffic.get("trace_seconds", 6.0)))
    window = {}

    def open_window() -> float:
        t0 = time.perf_counter()
        window["setup_s"] = t0 - t_start
        tracer.arm(t0, t0 + args.seconds)
        return t0

    ctx = SimpleNamespace(config=config, traffic=traffic, seed=args.seed, seconds=args.seconds,
                          device=device, tracer=tracer, open_window=open_window,
                          close_window=tracer.stop, test=test is not None)
    out = driver(traffic["driver"]).run(ctx)
    tracer.stop()
    found = loaded_forbidden()
    if found:
        raise CellError(f"JAX or the JAX package was loaded in this process: {found}")

    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    metrics = {}
    if args.trace:
        rec = SimpleNamespace(records=out["records"], trace=tracer.summarize(), config=config,
                              traffic=traffic, seconds=args.seconds)
        for m in cell_metrics(spec, "per_layer", args.workload):
            v = metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        values = {**out["metrics"], "setup_s": window["setup_s"]}
        for m in cell_metrics(spec, "end_to_end", args.workload):
            metrics[m["name"]] = {"value": finite(values[m["name"]]), "unit": units[m["name"]]}
    checks = out["checks"]
    correct = (out["failed"] == 0 and bool(checks)
               and all(math.isfinite(v) and v <= lim for v, lim in checks.values()))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if args.trace and tracer.summary is not None:
        dev["busy_s"] = tracer.summary.busy_s
        dev["window_s"] = tracer.summary.window_s
        result["breakdown"] = tracer.summary.breakdown()
    result["checks"] = {k: {"value": finite(v), "limit": lim} for k, (v, lim) in checks.items()}
    return result


def finite(v: float) -> float:
    """JSON has no infinity: a comparison that could not be made (an answer
    missing or of the wrong length) reads 1e300."""
    return float(v) if math.isfinite(v) else 1e300


def main(argv=None, t_start: float | None = None) -> int:
    try:
        result = run(argv, t_start)
    except CellError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False, default=_jsonable), flush=True)
    return 0


def _jsonable(x):
    if hasattr(x, "item"):
        return x.item()
    raise TypeError(f"not JSON serialisable: {type(x)}")
