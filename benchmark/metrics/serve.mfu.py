"""Forward FLOPs of the tiles each request answered ok needed (not the tile
bucket's padding), over the seconds they were answered in at the bf16
peak, in %: the window up to the profiler's start. Griffin-Lim's FFTs are
not counted."""
from benchmark import roofline
from benchmark.metrics._common import mfu, untraced_end


def read(run):
    reqs = run.records.get("requests")
    if not reqs:
        return None
    cut = untraced_end(run)
    tiles = sum(r["tiles"] for r in reqs if r["ok"] and r["read"] <= cut)
    per_tile = roofline.performancenet_forward_flops(run.config, 1, run.config["chunk_frames"])
    return mfu(tiles * per_tile, cut - run.records["t0"]) if tiles else None
