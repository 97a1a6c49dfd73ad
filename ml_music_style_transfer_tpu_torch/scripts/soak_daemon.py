"""Serving-daemon soak: many mixed requests through the daemon's loop
(``scripts/serve.py:serve_loop``) in one warm process. The port's
counterpart of the JAX package's ``scripts/soak_daemon.py``.

    python -m ml_music_style_transfer_tpu_torch.scripts.soak_daemon \\
        [--requests 100] [--width-mult 1.0] [--n-iter 300] [--pipeline-depth 2] \\
        [--out PATH] [--device cuda|cpu]

Request mix, per 25 requests: 17 single clips over three length buckets
(10, 20 and 30 s) and a novel length, 2 dynamic batches of two 10 s clips,
2 whole-clip requests and 4 malformed requests, in turn a missing file, an
empty MIDI, a corrupt WAV, bad JSON and an output path that cannot be
written, interleaved so that error isolation is exercised mid-stream. A
warm pass (one request per path and length) comes first. The model is a
PerformanceNet with random weights seeded 0.

Asserts (a failure raises):
  - every request but the malformed ones is answered ok, every malformed
    one ``{"ok": false}``, and the request after a malformed one succeeds;
  - the serving model cache never warns (no eviction at this mix);
  - every output WAV is finite and non-silent;
  - on the card: each Griffin-Lim run (a request, a batch item, a whole
    clip, the unwritable request, whose synthesis runs before its write
    fails) launches each glue kernel ``n_iter`` times, and the novel-length
    probe passes. Right after the warm pass, serially (depth 0), eight 10 s
    requests, the first request of the novel length (9.3 s of MIDI, 10.8 s
    of timbre: the 10 s clip's tile count, Griffin-Lim frames and STFT
    bucket, but lengths never served before) and eight more 10 s requests
    are timed; the novel one must take at most ``PROBE_MARGIN`` times the
    sixteen 10 s requests' p90. The JAX soak's probe guards against a
    recompile; the port compiles nothing per shape, so it guards against
    any first-touch cost of a new length that exceeds about half a request
    (a 10 s request takes 0.08-0.22 s on the H100). The margin covers the
    host clock's noise: its readings on the card are in PERF.md. In the
    pipelined stream a request's latency includes its wait behind the one
    before it, so the probe is served on its own.

Records p50/p90/p99 latency per request class, requests/s, peak device
memory and the card's ``nvidia-smi`` line in ``DAEMON_SOAK_H100.json`` at
the repository root (``DAEMON_SOAK_CPU.json`` with ``--device cpu``, whose
numbers are no device measurement), and prints it as the last line.
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import ModelConfig
from ..data.audio_io import read_wav, write_wav
from ..device import resolve_device
from ..infer import synthesize
from ..infer.synthesize import AudioSynthesizer
from ..midi import writer as midi_writer
from ..ops.kernels import gl_glue
from ..testing import synthetic
from . import serve
from .bench_inference import random_state, smi_line

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# name: (MIDI seconds, timbre seconds, style)
FIXTURES = {"a10": (10.0, 10.0, "cuba"), "b20": (20.0, 20.0, "upright"),
            "c30": (30.0, 30.0, "harpsichord"), "w10": (10.0, 10.0, "gentleman"),
            "novel": (9.3, 10.8, "aliciakeys")}
SINGLES = ("a10", "b20", "c30")
BAD_KINDS = ("missing_file", "empty_midi", "corrupt_wav", "bad_json", "unwritable_out")
PROBE_REPEATS = 16  # serial 10 s requests around the novel length's first, half before
PROBE_MARGIN = 1.5  # of their p90; set from the readings in PERF.md


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"soak: {msg}")


def make_fixtures(root: str) -> dict:
    """The fixture clips (MIDI + timbre WAV) and the malformed inputs."""
    rng = np.random.default_rng(0)
    fx = {}
    for name, (dur, adur, style) in FIXTURES.items():
        notes = synthetic.random_song(rng, duration=dur)
        mp, wp = os.path.join(root, f"{name}.mid"), os.path.join(root, f"{name}.wav")
        midi_writer.save(mp, notes)
        write_wav(wp, synthetic.render_notes(notes, style, duration=adur), 44100)
        fx[name] = (mp, wp)

    def stft_bucket(seconds: float) -> int:  # the serving path's half-chunk frame bucket
        return -(-(1 + int(seconds * 44100) // 256) // 430)

    _require(stft_bucket(FIXTURES["a10"][1]) == stft_bucket(FIXTURES["novel"][1]),
             "the novel probe's audio left the 10 s clip's STFT bucket")
    fx["bad_wav"] = os.path.join(root, "bad.wav")
    with open(fx["bad_wav"], "wb") as f:
        f.write(b"RIFFgarbage-not-a-wave-file")
    fx["empty_mid"] = os.path.join(root, "empty.mid")
    midi_writer.save(fx["empty_mid"], [])
    return fx


def request_plan(fx: dict, n: int, n_iter: int, out_dir: str) -> list[tuple[str, str, int]]:
    """``n`` requests as (JSON line, class, Griffin-Lim runs it makes)."""
    plan = []
    n_bad = 0
    for i in range(n):
        cyc = i % 25
        out = os.path.join(out_dir, f"o{i + 1}.wav")
        if cyc in (5, 12, 18, 23):  # malformed, interleaved mid-stream
            kind = BAD_KINDS[n_bad % len(BAD_KINDS)]
            n_bad += 1
            req = {"midi": fx["a10"][0], "audio": fx["a10"][1], "out": out, "n_iter": n_iter}
            runs = 0
            if kind == "missing_file":
                req["audio"] = os.path.join(out_dir, "missing", "nope.wav")
            elif kind == "empty_midi":
                req["midi"] = fx["empty_mid"]
            elif kind == "corrupt_wav":
                req["audio"] = fx["bad_wav"]
            elif kind == "unwritable_out":  # a path under a regular file
                req["out"] = os.path.join(fx["bad_wav"], "o.wav")
                runs = 1
            line = '{"this is not valid json' if kind == "bad_json" else json.dumps(req)
            plan.append((line, "bad", runs))
        elif cyc in (9, 20):  # dynamic batch of two 10 s clips
            plan.append((json.dumps({"batch": [
                {"midi": fx["a10"][0], "audio": fx["a10"][1], "out": out},
                {"midi": fx["a10"][0], "audio": fx["w10"][1],
                 "out": out.replace(".wav", "b.wav")}], "n_iter": n_iter}), "batch", 2))
        elif cyc in (3, 15):  # whole clip, one forward (the reference's semantics)
            plan.append((json.dumps({"midi": fx["w10"][0], "audio": fx["w10"][1], "out": out,
                                     "n_iter": n_iter, "whole_clip": True}), "whole", 1))
        elif cyc in (7, 21):  # a length the warm pass never saw, in the 10 s buckets
            plan.append((json.dumps({"midi": fx["novel"][0], "audio": fx["novel"][1],
                                     "out": out, "n_iter": n_iter}), "novel", 1))
        else:
            name = SINGLES[i % len(SINGLES)]
            plan.append((json.dumps({"midi": fx[name][0], "audio": fx[name][1], "out": out,
                                     "n_iter": n_iter}), f"single_{name[0]}", 1))
    return plan


def warm_plan(fx: dict, n_iter: int, out_dir: str) -> list[tuple[str, str, int]]:
    """One request per single-clip length, a whole clip and a batch."""
    def out(name):
        return os.path.join(out_dir, f"warm_{name}.wav")

    plan = [(json.dumps({"midi": fx[n][0], "audio": fx[n][1], "out": out(n), "n_iter": n_iter}),
             "warm", 1) for n in SINGLES]
    plan.append((json.dumps({"midi": fx["w10"][0], "audio": fx["w10"][1], "out": out("w"),
                             "n_iter": n_iter, "whole_clip": True}), "warm", 1))
    plan.append((json.dumps({"batch": [
        {"midi": fx["a10"][0], "audio": fx["a10"][1], "out": out("bat")},
        {"midi": fx["a10"][0], "audio": fx["w10"][1], "out": out("batb")}],
        "n_iter": n_iter}), "warm", 2))
    return plan


def novel_probe(make_synth, fx: dict, n_iter: int, out_dir: str) -> dict:
    """Serial seconds of ``PROBE_REPEATS`` 10 s requests, with the first
    request of the novel length served between their two halves."""
    def one(name: str, i: int) -> float:
        req = {"midi": fx[name][0], "audio": fx[name][1], "n_iter": n_iter,
               "out": os.path.join(out_dir, f"probe_{name}{i}.wav")}
        out = io.StringIO()
        serve.serve_loop(make_synth, io.StringIO(json.dumps(req) + "\n"), out, pipeline_depth=0)
        resp = json.loads(out.getvalue())
        _require(resp["ok"], f"probe request failed: {resp}")
        return resp["seconds"]

    half = PROBE_REPEATS // 2
    before = [one("a10", i) for i in range(half)]
    novel = one("novel", 0)
    bucket = before + [one("a10", i) for i in range(half, PROBE_REPEATS)]
    p90 = _pct(bucket, 90)
    return {"bucket_s": bucket, "bucket_p50_s": _pct(bucket, 50), "bucket_p90_s": p90,
            "novel_first_s": novel, "novel_over_p90": novel / p90, "margin": PROBE_MARGIN,
            "no_slower": novel <= PROBE_MARGIN * p90}


def _outputs(req_line: str) -> list[str]:
    try:
        req = json.loads(req_line)
    except json.JSONDecodeError:
        return []
    return [it["out"] for it in req["batch"]] if "batch" in req else [req["out"]]


def _pct(xs, q):
    return float(np.percentile(xs, q))


def run_soak(make_synth, root: str, requests: int = 100, n_iter: int = 300,
             pipeline_depth: int = 2, device: torch.device = torch.device("cuda")) -> dict:
    """The warm pass and the soak through ``serve.serve_loop`` with
    ``make_synth(midi, audio)``; fixtures and outputs under ``root``.
    Returns the record (see the module docstring); raises on a failed
    assert."""
    fx = make_fixtures(root)
    out_dir = os.path.join(root, "out")
    warm, plan = warm_plan(fx, n_iter, out_dir), request_plan(fx, requests, n_iter, out_dir)
    on_card = device.type == "cuda"
    launches0 = dict(gl_glue.LAUNCHES)

    warnings = []

    class _Catch(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    catcher = _Catch(level=logging.WARNING)
    logging.getLogger("mmst.serving").addHandler(catcher)
    try:
        t0 = time.perf_counter()
        served = serve.serve_loop(make_synth, io.StringIO("".join(x[0] + "\n" for x in warm)),
                                  io.StringIO(), pipeline_depth=pipeline_depth)
        warm_s = time.perf_counter() - t0
        _require(served == 6, f"warm pass served {served} of 6 clips")
        log(f"warm pass: {served} clips in {warm_s:.1f} s")
        probe = novel_probe(make_synth, fx, n_iter, out_dir)
        log(f"novel-length probe: {probe}")
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        out_s = io.StringIO()
        t0 = time.perf_counter()
        serve.serve_loop(make_synth, io.StringIO("".join(x[0] + "\n" for x in plan)), out_s,
                         pipeline_depth=pipeline_depth)
        wall = time.perf_counter() - t0
    finally:
        logging.getLogger("mmst.serving").removeHandler(catcher)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    resps = [json.loads(x) for x in out_s.getvalue().splitlines()]
    _require(len(resps) == len(plan), f"{len(resps)} responses to {len(plan)} requests")

    classes = [c for _, c, _ in plan]
    lat, violations, bad_ok, ok = {}, [], 0, 0
    for i, (resp, klass) in enumerate(zip(resps, classes)):
        lat.setdefault(klass, []).append(resp["seconds"])
        if klass == "bad":
            bad_ok += bool(resp.get("ok"))
            if i + 1 < len(resps) and classes[i + 1] != "bad" and not resps[i + 1].get("ok"):
                violations.append(i + 1)
        elif resp.get("ok") and all(r["ok"] for r in resp.get("batch", [])):
            ok += 1
    expected_ok = sum(c != "bad" for c in classes)
    log(f"soak: {len(plan)} requests in {wall:.1f} s; ok={ok}/{expected_ok} "
        f"bad-marked-ok={bad_ok} isolation_violations={violations} "
        f"cache_warnings={len(warnings)}")
    _require(bad_ok == 0, f"{bad_ok} malformed requests answered ok")
    _require(not violations, f"requests after a malformed one failed: {violations}")
    _require(ok == expected_ok, f"{ok} of {expected_ok} good requests ok: "
             f"{[r for r in resps if not r.get('ok')][:3]}")
    _require(not warnings, f"the model cache warned: {warnings[:3]}")
    n_wavs = 0
    for (line, klass, _), resp in zip(plan, resps):
        if klass == "bad":
            continue
        for path in _outputs(line):
            y, _ = read_wav(path, sr=None)
            _require(bool(np.isfinite(y).all()) and float(np.abs(y).max()) > 0.0,
                     f"{path} is not finite or silent")
            n_wavs += 1

    gl_runs = sum(r for _, _, r in warm) + PROBE_REPEATS + 1 + sum(r for _, _, r in plan)
    launches = {k: gl_glue.LAUNCHES[k] - launches0[k] for k in launches0}
    latency = {k: {"n": len(v), "p50": _pct(v, 50), "p90": _pct(v, 90), "p99": _pct(v, 99)}
               for k, v in sorted(lat.items())}
    if on_card:
        for k, v in launches.items():
            _require(v == n_iter * gl_runs,
                     f"{k} launched {v} times, expected {n_iter} x {gl_runs} Griffin-Lim runs")
        _require(probe["no_slower"], f"the novel length's first request took over "
                 f"{PROBE_MARGIN} x its bucket's p90: {probe}")
    return {
        "requests": len(plan),
        "wall_s": wall,
        "requests_per_s": len(plan) / wall,
        "warm_s": warm_s,
        "n_iter": n_iter,
        "pipeline_depth": pipeline_depth,
        "ok": ok,
        "expected_ok": expected_ok,
        "bad_requests": classes.count("bad"),
        "bad_kinds": list(BAD_KINDS),
        "isolation_violations": len(violations),
        "cache_warnings": len(warnings),
        "wavs_checked": n_wavs,
        "latency_s": latency,
        "novel_probe": probe,
        "griffinlim_runs": gl_runs,
        "glue_launches": launches,
        "peak_memory_GB": peak / 1e9 if peak is not None else "not measured",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--n-iter", type=int, default=300)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="JSON path (default: DAEMON_SOAK_H100.json, or DAEMON_SOAK_CPU.json "
                         "with --device cpu, at the repository root)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (checks the script)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    smi = None
    if dev.type == "cuda":
        from ..utils.profiling import enable_persistent_compile_cache

        enable_persistent_compile_cache(dev)
        smi = smi_line()
        log(smi)
    cfg = ModelConfig(width_mult=args.width_mult)
    state = random_state(cfg, dev)
    synthesize.clear_caches()  # the cache holds this soak's model alone
    with tempfile.TemporaryDirectory(prefix="mmst_soak_") as root:
        def make_synth(midi, audio):
            return AudioSynthesizer(root, midi, audio, model_cfg=cfg, params=state, device=dev)

        result = run_soak(make_synth, root, args.requests, args.n_iter, args.pipeline_depth, dev)
    result = {"device": {"kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "name_power_limit": smi},
              "width_mult": args.width_mult, **result}
    out = args.out or os.path.join(
        REPO_ROOT, "DAEMON_SOAK_H100.json" if dev.type == "cuda" else "DAEMON_SOAK_CPU.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    log(f"wrote {out}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
