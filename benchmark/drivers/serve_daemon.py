"""Serving through the program's daemon loop, in process.

``scripts/serve.serve_loop`` reads JSON request lines from a stream that
this driver feeds and writes one answer line per request, in order, to an
object here that stamps each with the host's clock as it arrives. The
model is a PerformanceNet of the configuration with seeded weights, served
from memory (``AudioSynthesizer(params=...)``).

Traffic (``traffic/<mix>.json``, ``traffic_gen.ServingTraffic``):
  - ``"mode": "backlog"``: requests are written whenever fewer than
    ``backlog`` are unanswered, a standing queue: the card sets the pace;
  - ``"mode": "open"``: Poisson arrivals at ``rate`` per second; each
    request is written when due and timed from its due time, so a stall
    shows in every request behind it. The generator's lateness is kept.

Set-up serves every score of the pool once (every tile count, Griffin-Lim
frame count and conditioning bucket the window meets). The window opens
with the daemon idle and closes after ``seconds``; what is unanswered then
is waited for, a minute at most, and a request that never gets an ``ok``
answer counts as failed.

End-to-end: ``serve_audio_s_per_s`` (seconds of waveform answered ok
inside the window over its seconds) and ``serve_request_p95_s`` (the 95th
percentile of due-to-answer latency over every request due in the window,
a failed one counting as infinite).

Correct: once the window has closed and the program's state is freed, a
sample of the answered requests drawn from the seed, the longest among
them, is worked out again by ``reference/serving.py`` and compared with the
WAV the daemon wrote.
"""
from __future__ import annotations

import gc
import json
import math
import queue
import tempfile
import threading
import time

import numpy as np
import torch

from .. import traffic_gen, weights
from ..reference import dsp, nets, serving
from . import program_config

DRAIN_S = 60.0


class Daemon:
    """``serve_loop`` in a thread, fed line by line; its answers stamped."""

    def __init__(self, make_synth, depth: int, serve_loop=None):
        if serve_loop is None:
            from ml_music_style_transfer_tpu_torch.scripts.serve import serve_loop

        self.lines: queue.Queue = queue.Queue()
        self.cv = threading.Condition()
        self.sent: list[tuple[float, float, dict]] = []  # (due, written, request)
        self.answers: list[tuple[float, dict]] = []     # (read, answer)
        self.error: list[BaseException] = []
        # called by serve_loop's reader thread, which launches the card's
        # work, before each line and while it waits for one
        self.tick = lambda: None

        def serve():
            try:
                serve_loop(make_synth, self._stream(), self, pipeline_depth=depth)
            except BaseException as e:  # noqa: BLE001 — reported by close()
                self.error.append(e)
                with self.cv:
                    self.cv.notify_all()

        self.thread = threading.Thread(target=serve, name="bench-daemon", daemon=True)
        self.thread.start()

    def _stream(self):
        while True:
            self.tick()
            try:
                line = self.lines.get(timeout=0.05)
            except queue.Empty:
                continue
            if line is None:
                return
            yield line

    # serve_loop's out_stream
    def write(self, s: str) -> None:
        t = time.perf_counter()
        with self.cv:
            self.answers.extend((t, json.loads(line)) for line in s.splitlines() if line.strip())
            self.cv.notify_all()

    def flush(self) -> None:
        pass

    def send(self, request: dict, due: float) -> None:
        with self.cv:
            self.sent.append((due, time.perf_counter(), request))
            self.lines.put(json.dumps(request))

    def unanswered(self) -> int:
        with self.cv:
            return len(self.sent) - len(self.answers)

    def wait_all(self, deadline: float) -> None:
        with self.cv:
            while len(self.answers) < len(self.sent) and not self.error:
                left = deadline - time.perf_counter()
                if left <= 0:
                    return
                self.cv.wait(min(left, 0.5))

    def close(self) -> None:
        self.lines.put(None)
        self.thread.join(DRAIN_S)
        if self.thread.is_alive():
            raise RuntimeError("the daemon did not stop")


def _window_backlog(ctx, daemon, traffic, n_back: int, t0: float, end: float, k: int) -> None:
    pairs: list = []
    while True:
        now = time.perf_counter()
        if now >= end or daemon.error:
            return
        while daemon.unanswered() < n_back:
            if not pairs:
                pairs = traffic.block()
            daemon.send(traffic.request(k, pairs.pop()), time.perf_counter())
            k += 1
        with daemon.cv:
            daemon.cv.wait(min(0.05, max(0.0, end - now)))


def _window_open(ctx, daemon, traffic, rate: float, t0: float, end: float, k: int) -> None:
    gaps = traffic.gaps(rate, end - t0)
    pairs: list = []
    due = t0
    for g in gaps:
        due += g
        while True:
            left = min(due, end) - time.perf_counter()
            if left <= 0:
                break
            time.sleep(min(left, 0.05))
        if due >= end:
            return
        if not pairs:
            pairs = traffic.block()
        daemon.send(traffic.request(k, pairs.pop()), due)
        k += 1


def account(daemon: Daemon, k0: int, traffic, cfg: dict) -> list[dict]:
    """One record per request written from ``k0`` on (the window's), matched
    with its answer by order: its due and read times, latency from due
    (infinite where no ``ok`` answer came), audio seconds and tiles."""
    fps = cfg["sr"] // cfg["hop"]
    by_path = {m["path"]: m for m in traffic.midis}
    reqs = []
    for i, (due, written, req) in enumerate(daemon.sent[k0:], start=k0):
        frames = int(by_path[req["midi"]]["seconds"] * fps)
        r = {"due": due, "late": written - due, "audio_s": frames * cfg["hop"] / cfg["sr"],
             "tiles": serving.n_tiles(frames, cfg["chunk_frames"]), "req": req,
             "ok": False, "read": math.inf, "daemon_s": None}
        if i < len(daemon.answers):
            t, ans = daemon.answers[i]
            r.update(ok=bool(ans.get("ok")), read=t, daemon_s=ans.get("seconds"),
                     error=ans.get("error"))
        r["latency"] = r["read"] - due if r["ok"] else math.inf
        reqs.append(r)
    return reqs


def window_metrics(reqs: list[dict], end: float, seconds: float) -> dict:
    """Audio seconds answered ok by the window's close over its seconds;
    the 95th percentile of latency over every request due in it."""
    done = [r for r in reqs if r["ok"] and r["read"] <= end]
    out = {"serve_audio_s_per_s": sum(r["audio_s"] for r in done) / seconds}
    if reqs:
        out["serve_request_p95_s"] = percentile([r["latency"] for r in reqs], 95)
    return out


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile, nearest rank (a missing answer, inf, sorts last)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def run(ctx) -> dict:
    from ml_music_style_transfer_tpu_torch.infer import synthesize
    from ml_music_style_transfer_tpu_torch.utils.profiling import enable_persistent_compile_cache

    cfg, mix = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    model_cfg = program_config.performancenet(cfg)
    enable_persistent_compile_cache(dev)
    fps = cfg["sr"] // cfg["hop"]
    tmp = tempfile.TemporaryDirectory(prefix="bench_serve_")
    try:
        traffic = traffic_gen.ServingTraffic(mix, ctx.seed, tmp.name, fps)
        shapes = nets.performancenet_shapes(cfg)
        w_seed = traffic_gen.sub_seed(ctx.seed, "weights")
        params = weights.make(shapes, w_seed, dev)

        def make_synth(midi, audio):
            return synthesize.AudioSynthesizer(tmp.name, midi, audio, model_cfg=model_cfg,
                                               params=params, device=dev)

        daemon = Daemon(make_synth, int(mix["pipeline_depth"]))
        for k, pair in enumerate(traffic.warmup_pairs()):
            daemon.send(traffic.request(-1 - k, pair), time.perf_counter())
        daemon.wait_all(time.perf_counter() + 600.0)
        warm = [a for _, a in daemon.answers]
        if len(warm) != len(daemon.sent) or not all(a.get("ok") for a in warm):
            raise RuntimeError(f"set-up requests failed: {warm}")
        k0 = len(daemon.sent)
        t0 = ctx.open_window()
        end = t0 + ctx.seconds

        def tick():  # in the reader thread: the profiler sees what it launches
            if time.perf_counter() < end:
                ctx.tracer.poll()
            else:
                ctx.close_window()

        daemon.tick = tick
        if mix["mode"] == "backlog":
            _window_backlog(ctx, daemon, traffic, int(mix["backlog"]), t0, end, 0)
        else:
            _window_open(ctx, daemon, traffic, float(mix["rate"]), t0, end, 0)
        daemon.wait_all(max(end, time.perf_counter()) + DRAIN_S)
        daemon.close()  # its reader stops the tracer first
        if dev.type == "cuda":
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        if daemon.error:
            raise daemon.error[0]

        reqs = account(daemon, k0, traffic, cfg)
        metrics = window_metrics(reqs, end, ctx.seconds)
        failed = sum(not r["ok"] for r in reqs)
        records = {"requests": reqs, "t0": t0, "end": end, "window_s": ctx.seconds}

        del make_synth, params
        synthesize.clear_caches()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks = check(ctx, cfg, mix, reqs, shapes, w_seed, dev, traffic)
    finally:
        tmp.cleanup()
    return {"attempted": len(reqs), "failed": failed, "metrics": metrics, "records": records,
            "checks": checks, "memory_peak_bytes": peak}


def check(ctx, cfg, mix, reqs, shapes, w_seed, dev, traffic) -> dict:
    """The worst gaps of a seeded sample of answered requests, the longest
    among them, against the reference, each with its limit."""
    ok = [r for r in reqs if r["ok"]]
    if not ok:
        return {name: (math.inf, lim) for name, lim in mix["limits"].items()}
    rng = np.random.default_rng(traffic_gen.sub_seed(ctx.seed, "check"))
    longest = max(ok, key=lambda r: r["audio_s"])
    rest = [r for r in ok if r is not longest]
    n = min(len(rest), int(mix["check_requests"]) - 1)
    sample = [longest] + [rest[i] for i in rng.choice(len(rest), n, replace=False)]
    by_path = {m["path"]: m for m in traffic.midis}
    worst: dict[str, float] = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = weights.make(shapes, w_seed, dev)
        for r in sample:
            notes = traffic_gen.notes_seconds(by_path[r["req"]["midi"]]["notes"])
            ref = serving.waveform(params, cfg, notes, r["req"]["audio"], dev,
                                   int(r["req"]["n_iter"]))
            served, _ = dsp.read_wav_int16(r["req"]["out"])
            for name, v in serving.gaps(served, ref, cfg["n_fft"], cfg["hop"]).items():
                worst[name] = max(worst.get(name, 0.0), v)
        del params
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {name: (worst[name], lim) for name, lim in mix["limits"].items()}
