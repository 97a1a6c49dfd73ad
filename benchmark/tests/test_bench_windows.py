"""The windows' arithmetic without the program: an open loop times every
request from when it was due and counts one never answered as failed, and
each rate is all the work over all the window's time."""
import json
import math
import threading
import time
from types import SimpleNamespace

from benchmark import training
from benchmark.drivers import serve_daemon

CFG = {"sr": 44100, "hop": 256, "chunk_frames": 860}


class Traffic:
    """Two scores (10 s, 20 s); gaps of 0.05 s."""

    midis = [{"path": "a.mid", "seconds": 10.0}, {"path": "b.mid", "seconds": 20.0}]

    def gaps(self, rate, seconds):
        return [1.0 / rate] * round(rate * seconds)

    def block(self):
        return [(0, 0), (1, 0)]

    def request(self, k, pair):
        return {"midi": self.midis[pair[0]]["path"], "k": k}


def fake_loop(service_s: float, answer_first: int):
    """A daemon that takes ``service_s`` per request, in order, and stops
    answering (but keeps reading) after ``answer_first`` requests."""
    def serve_loop(make_synth, in_stream, out_stream, pipeline_depth=2):
        for n, line in enumerate(in_stream):
            if n >= answer_first:
                continue
            t = time.perf_counter()
            time.sleep(service_s)
            out_stream.write(json.dumps({"ok": True, "seconds": time.perf_counter() - t}) + "\n")
    return serve_loop


def ctx(seconds):
    return SimpleNamespace(seconds=seconds, tracer=SimpleNamespace(poll=lambda: None, t0=None),
                           open_window=time.perf_counter, close_window=lambda: None)


def test_open_loop_times_from_due_and_counts_the_unanswered_as_failed():
    daemon = serve_daemon.Daemon(None, 2, serve_loop=fake_loop(0.08, answer_first=6))
    t0 = time.perf_counter()
    end = t0 + 0.47
    serve_daemon._window_open(ctx(0.47), daemon, Traffic(), 20.0, t0, end, 0)
    daemon.wait_all(time.perf_counter() + 1.0)
    reqs = serve_daemon.account(daemon, 0, Traffic(), CFG)
    daemon.close()
    assert len(reqs) == 9  # due at 0.05, 0.10, ..., 0.45
    for k, r in enumerate(reqs):
        assert math.isclose(r["due"], t0 + 0.05 * (k + 1), abs_tol=1e-9)
    ok, lost = reqs[:6], reqs[6:]
    # service (0.08 s) is slower than arrivals (0.05 s): the queue grows, and
    # the latency from due holds the wait the daemon's own seconds leave out
    for r in ok:
        assert r["latency"] == r["read"] - r["due"]
        assert r["latency"] >= r["daemon_s"]
    assert ok[-1]["latency"] - ok[-1]["daemon_s"] > 0.1
    assert all(not r["ok"] and r["latency"] == math.inf for r in lost)
    m = serve_daemon.window_metrics(reqs, end, 0.47)
    assert m["serve_request_p95_s"] == math.inf


def test_serving_rate_is_the_audio_answered_by_the_close_over_the_window():
    reqs = [{"ok": True, "read": 1.0, "audio_s": 10.0, "latency": 0.1},
            {"ok": True, "read": 2.5, "audio_s": 20.0, "latency": 0.2},
            {"ok": False, "read": math.inf, "audio_s": 30.0, "latency": math.inf},
            {"ok": True, "read": 4.0, "audio_s": 40.0, "latency": 0.3}]
    m = serve_daemon.window_metrics(reqs, end=3.0, seconds=2.0)
    assert m["serve_audio_s_per_s"] == (10.0 + 20.0) / 2.0


def test_backlog_keeps_the_queue_full():
    seen = []
    lock = threading.Lock()

    def loop(make_synth, in_stream, out_stream, pipeline_depth=2):
        for line in in_stream:
            time.sleep(0.02)
            with lock:
                seen.append(line)
            out_stream.write(json.dumps({"ok": True, "seconds": 0.02}) + "\n")

    daemon = serve_daemon.Daemon(None, 2, serve_loop=loop)
    t0 = time.perf_counter()
    serve_daemon._window_backlog(ctx(0.3), daemon, Traffic(), 4, t0, t0 + 0.3, 0)
    # an answer read in the window's last wait is not replaced once it has closed
    assert daemon.unanswered() in (3, 4)
    daemon.wait_all(time.perf_counter() + 1.0)
    daemon.close()
    assert len(seen) == len(daemon.sent) >= 10


def test_training_rate_counts_every_step_and_the_time_until_the_last_is_done():
    calls = []

    def step():
        calls.append(time.perf_counter())
        time.sleep(0.04)

    win = training.window(ctx(0.2), step, SimpleNamespace(type="cpu"))
    assert win["steps"] == len(calls) == len(win["issued"]) >= 5
    assert win["seconds"] >= 0.2
    assert win["t0"] + win["seconds"] >= calls[-1] + 0.04 - 1e-3
