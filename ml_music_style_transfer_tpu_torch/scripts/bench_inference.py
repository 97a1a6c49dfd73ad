"""Benchmark the serving system end to end on the card.

    python -m ml_music_style_transfer_tpu_torch.scripts.bench_inference \\
        [--width-mult 1.0] [--n-iter 300] [--seconds 30] [--daemon-requests 6] \\
        [--skip-whole-clip] [--probe-cap-seconds 960] [--out-dir .] \\
        [--profile-dir DIR] [--device cuda]

The port's counterpart of the JAX package's ``scripts/bench_inference.py``.
A PerformanceNet with seeded random weights (full width by default,
bfloat16 compute) serves synthetic MIDI + timbre clips
(``testing/synthetic.py``, seeded) through the entry points a user calls,
after one warm-up of each path, and the script prints one ``metric`` line
per number, under the names ``chip_smoke.py`` prints them:

  - ``serving_s_per_30s_clip``: ``AudioSynthesizer.synthesize_waveform``
    of a ``--seconds`` MIDI with a timbre clip as long, warm (best of 3);
  - ``griffinlim_s_per_10s_clip``: Griffin-Lim (``n_iter`` iterations) of a
    10 s clip's spectrogram, 1720 frames (best of 3);
  - ``whole_clip_s_per_30s_clip``: ``synthesize_whole_clip``, warm (best of
    3), unless ``--skip-whole-clip``;
  - ``daemon_requests_per_s_pipelined`` / ``_serial``: ``serve_loop`` over
    ``--daemon-requests`` requests of 10 s at pipeline depth 2 and 0, and
    their ratio (0 requests skips them);
  - ``batch_griffinlim_s_per_clip``: ``bulk_griffinlim`` of four 10 s
    spectrograms over four.

The whole-clip section (the reference's own inference, one forward with
InstanceNorm statistics over the whole clip, model/inference.py:82-84)
also reports, as the JAX script does: the divergence between the tiled
spectrogram (``_predict_device``) and the whole-clip one
(``predict_spectrogram_whole_clip``) on the same inputs (relative L2, over
the interior past an 860-frame margin, mean |difference| and the
spectrogram's mean level); and, doubling from 60 s up to
``--probe-cap-seconds`` (0 skips it), the longest clip one device serves
in one pass (``synthesize_whole_clip`` with 30 iterations; only
``torch.cuda.OutOfMemoryError`` ends the probe, any other error
propagates). It writes them to ``--out-dir``/``SERVING_WHOLECLIP_H100.json``
(``_CPU`` on the CPU; ``_W{w}`` after it at another width), with the card's
name and power limit inside. ``--profile-dir`` writes a trace of one
steady ``synthesize_waveform`` there (``utils/profiling.device_trace``).

Each time is on the host clock around work that ends in a device sync (a
waveform on the host). Before the metrics it prints the card's name and
power limit (``nvidia-smi``). ``--device cpu`` runs the same code on the
CPU to check the script at a small width; its numbers are CPU numbers.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..config import ModelConfig
from ..data import audio_io
from ..device import resolve_device
from ..infer import bulk
from ..infer import synthesize as S
from ..midi import writer as midi_writer
from ..models import PerformanceNet
from ..ops import griffinlim as tgl
from ..testing import synthetic
from ..utils import profiling
from . import serve

GL_FRAMES_10S = 1720  # a 10 s clip's frames rounded up to half a chunk
PROBE_START_SECONDS = 60.0  # the first clip of the one-pass probe, doubled after
PROBE_N_ITER = 30  # Griffin-Lim iterations of each probe clip: the memory is the forward's
MARGIN_FRAMES = 860  # the interior of the divergence starts a chunk in from each edge
DAEMON_SECONDS = 10.0  # MIDI length of each daemon request
SPIN_CYCLES = 2_000_000_000  # torch.cuda._sleep: about 1 s at the H100's boost clock


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def metric_line(name: str, value: float, unit: str, device: torch.device, **extra) -> str:
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    tail = "".join(f" {k}={v}" for k, v in extra.items())
    return f"metric {name}={value:.6g} {unit} device={where!r}{tail}"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_clip(root: str, name: str, seconds: float, seed: int,
              timbre_seconds: float | None = None) -> tuple[str, str]:
    """A seeded random song as ``<name>.mid`` and its harpsichord rendering
    (``timbre_seconds`` long, default the song's) as ``<name>.wav``. Four
    notes a second, so the song lasts its ``seconds`` (at the default three
    it ends about a tenth early)."""
    notes = synthetic.random_song(np.random.default_rng(seed), duration=seconds,
                                  notes_per_sec=4.0)
    midi = os.path.join(root, f"{name}.mid")
    wav = os.path.join(root, f"{name}.wav")
    midi_writer.save(midi, notes)
    audio_io.write_wav(wav, synthetic.render_notes(
        notes, "harpsichord", duration=timbre_seconds or seconds), 44100)
    return midi, wav


def random_state(cfg: ModelConfig, device: torch.device) -> dict:
    """A PerformanceNet's state_dict on ``device``, weights seeded 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return PerformanceNet(cfg, device=device, generator=gen).state_dict()


def best_seconds(fn, device: torch.device) -> float:
    """Least host-clock time of 3 calls of ``fn``, each ended by a device
    sync."""
    times = []
    for _ in range(3):
        sync(device)
        t = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t)
    return min(times)


def daemon_seconds(make_synth, requests: list[dict], depth: int) -> tuple[float, list[dict]]:
    """Wall seconds of ``serve.serve_loop`` over ``requests`` (JSON lines
    in, responses parsed) at ``pipeline_depth=depth``."""
    payload = "".join(json.dumps(r) + "\n" for r in requests)
    out = io.StringIO()
    t = time.perf_counter()
    serve.serve_loop(make_synth, io.StringIO(payload), out, pipeline_depth=depth)
    dt = time.perf_counter() - t
    return dt, [json.loads(line) for line in out.getvalue().splitlines()]


def async_probe(synth, n_iter: int) -> dict:
    """One request through ``synthesize_waveform_async`` (card only).

    Reports the time the call takes to return and whether its work was
    still pending then; then about 1 s of later work is queued on the card
    (``torch.cuda._sleep``, as the next request's would be) before
    ``fetch()``, which must wait for this request only: it reports the time
    to ``fetch()`` and whether the later work was still running when it
    returned. Host clock from the call."""
    dev = synth.device
    sync(dev)
    t0 = time.perf_counter()
    fetch = synth.synthesize_waveform_async(n_iter=n_iter)
    returned = time.perf_counter() - t0
    queued = torch.cuda.Event()
    queued.record()
    pending = not queued.query()
    torch.cuda._sleep(SPIN_CYCLES)
    later = torch.cuda.Event()
    later.record()
    fetch()
    fetched = time.perf_counter() - t0
    later_running = not later.query()
    sync(dev)
    return dict(return_s=returned, pending_at_return=pending, fetch_s=fetched,
                later_work_running_at_fetch=later_running)


def staging_probe(device: torch.device) -> dict:
    """Behind about 1 s of earlier work on the card (``torch.cuda._sleep``),
    the time to upload 21 MB (a 30 s request's Griffin-Lim phase) through
    the serving seam
    (``synthesize._stage``: pinned memory, a copy that does not wait) and
    through a plain pageable ``.to(device)``, and whether the earlier work
    was still running when each returned (card only)."""
    a = np.ones((21 << 20) // 4, np.float32)
    out = {}
    for name, upload in (("staged", lambda: S._stage(a, device)),
                         ("pageable", lambda: torch.from_numpy(a).to(device))):
        sync(device)
        torch.cuda._sleep(SPIN_CYCLES)
        earlier = torch.cuda.Event()
        earlier.record()
        t = time.perf_counter()
        upload()
        out[f"{name}_s"] = time.perf_counter() - t
        out[f"{name}_returned_while_earlier_work_ran"] = not earlier.query()
        sync(device)
    return out


def launch_queue_probe(device: torch.device) -> int | None:
    """Behind about 1 s of earlier work on the card, the number of tiny
    kernels the host queues before a launch blocks for more than 0.1 s:
    how far the host can run ahead of the card (card only)."""
    x = torch.zeros(1, device=device)
    sync(device)
    torch.cuda._sleep(SPIN_CYCLES)
    blocked_at = None
    for k in range(20000):
        t = time.perf_counter()
        x.add_(1.0)
        if time.perf_counter() - t > 0.1:
            blocked_at = k
            break
    sync(device)
    return blocked_at


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-9)


def divergence(synth) -> dict:
    """The tiled serving spectrogram against the whole-clip one on the
    synthesizer's inputs (the JAX script's measure): relative L2, the same over the
    interior (an 860-frame margin, a quarter of the clip where it is
    shorter than three chunks), mean |difference| and the whole-clip
    spectrogram's mean level."""
    spec_dev, t_tiled = synth._predict_device(synth.midi_source, synth.audio_source)
    tiled = S._fetch(spec_dev.float())[:t_tiled]
    roll, onoff, cond, t_total = synth.process_whole_clip(synth.midi_source, synth.audio_source)
    with torch.inference_mode():
        whole = np.asarray(synth.predict_spectrogram_whole_clip(roll, onoff, cond, t_total),
                           np.float32)
    t = min(tiled.shape[0], whole.shape[0])
    a, b = tiled[:t], whole[:t]
    margin = MARGIN_FRAMES if t > 3 * MARGIN_FRAMES else t // 4
    return {"t_frames_compared": int(t), "interior_margin_frames": int(margin),
            "rel_l2": rel_l2(a, b),
            "interior_rel_l2": rel_l2(a[margin:t - margin], b[margin:t - margin]),
            "mean_abs": float(np.mean(np.abs(a - b))),
            "spec_mean_abs_level": float(np.mean(np.abs(b))),
            "params": "random-init"}


def longest_one_pass(make_synth, root: str, cap_s: float) -> dict:
    """Clips of 60, 120, 240, ... s up to ``cap_s``, each served whole
    (``synthesize_whole_clip``, 30 iterations), until one does not fit the
    device: only ``torch.cuda.OutOfMemoryError`` ends the probe (the cache
    is freed after it); any other exception propagates."""
    ok_s, fail_s, fail_err, seconds = 0.0, None, "", {}
    dur = PROBE_START_SECONDS
    while dur <= cap_s:
        midi, wav = make_clip(root, f"probe_{int(dur)}", dur, 1, timbre_seconds=min(dur, 30.0))
        synth = make_synth(midi, wav)
        t = time.perf_counter()
        try:
            out = synth.synthesize_whole_clip(n_iter=PROBE_N_ITER)
        except torch.cuda.OutOfMemoryError as e:
            fail_s, fail_err = dur, f"{type(e).__name__}: {e}"[:300]
            print(f"[whole-clip probe] {dur:.0f} s clip out of memory", flush=True)
            del synth
            torch.cuda.empty_cache()
            break
        if not np.isfinite(out).all():
            raise RuntimeError(f"the {dur:.0f} s whole clip is not finite")
        seconds[f"{dur:g}"] = time.perf_counter() - t
        print(f"[whole-clip probe] {dur:.0f} s clip OK ({seconds[f'{dur:g}']:.2f} s)",
              flush=True)
        ok_s = dur
        del synth, out
        dur *= 2
    return {"longest_ok_s": ok_s, "first_fail_s": fail_s, "fail_error": fail_err,
            "cap_s": cap_s, "n_iter": PROBE_N_ITER, "seconds": seconds}


def whole_clip_section(args, synth, make_synth, root: str, dev: torch.device, tiled_s: float,
                       report) -> dict:
    """The JAX script's whole-clip section: time, divergence, probe; the
    dict it writes to ``SERVING_WHOLECLIP_*.json`` under ``--out-dir``."""
    n_iter = args.n_iter
    synth.synthesize_whole_clip(n_iter=n_iter)  # warm-up
    steady = best_seconds(lambda: synth.synthesize_whole_clip(n_iter=n_iter), dev)
    report("whole_clip_s_per_30s_clip", steady, "s", midi_s=args.seconds, n_iter=n_iter)
    wc = {"seconds": args.seconds, "width_mult": args.width_mult, "n_iter": n_iter,
          "device": smi_line() if dev.type == "cuda" else "cpu",
          "steady_s": steady, "tiled_steady_s": tiled_s,
          "wholeclip_over_tiled": steady / tiled_s,
          "divergence": divergence(synth)}
    d = wc["divergence"]
    print(f"[whole-clip] tiled vs whole divergence: rel_l2={d['rel_l2']:.4f} interior="
          f"{d['interior_rel_l2']:.4f} mean_abs={d['mean_abs']:.4f} (spec level "
          f"{d['spec_mean_abs_level']:.4f})", flush=True)
    if args.probe_cap_seconds > 0:
        wc["max_onepass_probe"] = probe = longest_one_pass(make_synth, root,
                                                           args.probe_cap_seconds)
        print(f"[whole-clip probe] longest_ok_s={probe['longest_ok_s']:g} "
              f"first_fail_s={probe['first_fail_s']}", flush=True)
    suffix = "" if args.width_mult == 1.0 else "_W" + f"{args.width_mult:g}".replace(".", "p")
    name = f"SERVING_WHOLECLIP_{'H100' if dev.type == 'cuda' else 'CPU'}{suffix}.json"
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, name), "w") as f:
        json.dump(wc, f, indent=1)
    return wc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--n-iter", type=int, default=300)
    ap.add_argument("--daemon-requests", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="MIDI length of the serving and whole-clip requests")
    ap.add_argument("--skip-whole-clip", action="store_true",
                    help="skip the whole-clip one-pass section")
    ap.add_argument("--probe-cap-seconds", type=float, default=960.0,
                    help="longest clip the one-pass probe tries (doubling from 60 s; 0 skips it)")
    ap.add_argument("--out-dir", default=".",
                    help="where the whole-clip section writes SERVING_WHOLECLIP_*.json")
    ap.add_argument("--profile-dir", default=None,
                    help="write a trace of one steady synthesize_waveform here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (checks the script)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_iter = args.n_iter
    if dev.type == "cuda":
        print(smi_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(width_mult=args.width_mult)
    state = random_state(cfg, dev)
    metrics = {}

    def report(name, value, unit, **extra):
        metrics[name] = value
        print(metric_line(name, value, unit, dev, **extra), flush=True)

    with tempfile.TemporaryDirectory(prefix="mmst_bench_") as root:
        def make_synth(midi, wav):
            return S.AudioSynthesizer(root, midi, wav, model_cfg=cfg, params=state, device=dev)

        long_midi, long_wav = make_clip(root, "long", args.seconds, 0)
        synth = make_synth(long_midi, long_wav)
        synth.synthesize_waveform(n_iter=n_iter)  # warm-up
        report("serving_s_per_30s_clip",
               best_seconds(lambda: synth.synthesize_waveform(n_iter=n_iter), dev), "s",
               midi_s=args.seconds, n_iter=n_iter)

        spec = torch.rand((1025, GL_FRAMES_10S), generator=torch.Generator().manual_seed(1)) * 8
        spec = spec.to(dev)

        def gl():
            with torch.inference_mode():
                tgl.griffinlim_from_log_power(spec, n_iter=n_iter, device=dev).cpu()

        gl()
        report("griffinlim_s_per_10s_clip", best_seconds(gl, dev), "s",
               frames=GL_FRAMES_10S, n_iter=n_iter)

        if not args.skip_whole_clip:
            wc = whole_clip_section(args, synth, make_synth, root, dev,
                                    metrics["serving_s_per_30s_clip"], report)
            print("[whole-clip] " + json.dumps(wc), flush=True)

        if args.profile_dir:
            with profiling.device_trace(args.profile_dir):
                synth.synthesize_waveform(n_iter=n_iter)
            print(f"[profile] trace of one steady synthesize_waveform written to "
                  f"{args.profile_dir}", flush=True)

        k = args.daemon_requests
        if k > 0:
            clips = [make_clip(root, f"d{i}", DAEMON_SECONDS, 10 + i) for i in range(k)]
            reqs = [{"midi": m, "audio": w, "out": os.path.join(root, f"out{i}.wav"),
                     "n_iter": n_iter} for i, (m, w) in enumerate(clips)]
            daemon_seconds(make_synth, reqs, 2)  # warm-up
            serial, resp_s = daemon_seconds(make_synth, reqs, 0)
            piped, resp_p = daemon_seconds(make_synth, reqs, 2)
            if not all(r["ok"] for r in resp_s + resp_p):
                raise RuntimeError(f"daemon request failed: {resp_s + resp_p}")
            report("daemon_requests_per_s_serial", k / serial, "requests/s", requests=k)
            report("daemon_requests_per_s_pipelined", k / piped, "requests/s", requests=k,
                   pipelined_over_serial=round(serial / piped, 4))

        specs = torch.rand((4, 1025, GL_FRAMES_10S), generator=torch.Generator().manual_seed(2))
        specs = (specs * 8).to(dev)

        def batch_gl():
            bulk.bulk_griffinlim(specs, [0, 1, 2, 3], n_iter=n_iter, device=dev).cpu()

        batch_gl()
        report("batch_griffinlim_s_per_clip", best_seconds(batch_gl, dev) / 4, "s",
               clips=4, frames=GL_FRAMES_10S, n_iter=n_iter)
    print(json.dumps({"metrics": metrics, "device": str(dev),
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}))
    return metrics


if __name__ == "__main__":
    main()
