"""Long-lived serving daemon: JSON-lines requests -> synthesized WAVs.

The port's counterpart of the JAX package's ``scripts/serve.py``. The
one-shot CLI (``infer/cli.py``) pays process start-up, kernel build and
checkpoint load per clip; this daemon holds the warm state (the built
kernels and the module-level model cache of ``infer/synthesize.py``), so
every request after the first runs at steady serving speed.

Requests are PIPELINED: the reader thread parses, uploads and queues the
card's work (``AudioSynthesizer.synthesize_waveform_async``); one completer
thread waits for each result, writes the WAV and answers in request order,
so host prep of request N+1 overlaps the card's work on request N
(``--pipeline-depth``, default 2; 0 is serial).

Protocol: one JSON object per stdin line ->
    {"midi": PATH, "audio": PATH, "out": PATH,
     "n_iter": 300, "cond_mode": "aligned"|"center",
     "overlap": true, "whole_clip": false,
     # whole-clip extras: shard_gl (default auto) time-shards Griffin-Lim
     # over the mesh alongside the forward (parallel/gl_shard.py)
     "shard_gl": null|true|false, "gl_halo": 32, "gl_rounds": 10}
one JSON response per stdout line:
    {"ok": true, "out": PATH, "seconds": S, "realtime_x": R}
    {"ok": false, "error": "..."}
EOF (or a line "quit") shuts down cleanly.

Dynamic batching: a request may instead carry a list of clips ->
    {"batch": [{"midi": PATH, "audio": PATH, "out": PATH}, ...],
     "n_iter": 300, "cond_mode": "aligned", "overlap": true}
All clips' forwards run device-resident, then equal-length clips share ONE
Griffin-Lim dispatch (batched over the data mesh when --mesh-data > 1;
infer/bulk.py). The response is one line with per-item results:
    {"ok": true, "batch": [{"ok": true, "out": PATH} | {"ok": false,
     "error": "..."}, ...], "seconds": S}

(The protocol is the JAX daemon's, word for word.)

Usage:
    python -m ml_music_style_transfer_tpu_torch.scripts.serve -exp-name NAME \\
        [--width-mult F] [--checkpoint PATH] [--use-ema] [--device cuda|cpu] \\
        < requests.jsonl

Over several cards, one rank per card under torchrun:
    torchrun --nproc-per-node N -m ml_music_style_transfer_tpu_torch.scripts.serve \\
        -exp-name NAME --mesh-data N < requests.jsonl
Rank 0 reads the requests and answers them; it sends each batch and
whole-clip request to the other ranks, which run it with it: a batch's
clips split over the ranks (``infer/bulk.py``), and a whole clip's forward
(and, by ``shard_gl``, its Griffin-Lim) shards its time axis over them
(``parallel/time_shard.py``, ``gl_shard.py``). Single requests run on rank
0's card. ``--mesh-data`` must equal the launch's rank count.

``--checkpoint`` (default: the experiment's best) may be a port ``.pt`` or
``.dcp``, a JAX ``.msgpack`` or ``.orbax`` or a reference ``.tar``; only the
served tree is read at start-up. ``--use-ema`` serves the EMA
weights of a run trained with ``--ema-decay``.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ..config import ModelConfig
from ..data import audio_io
from ..device import resolve_device
from ..infer import bulk
from ..infer.synthesize import AudioSynthesizer
from ..midi import writer as midi_writer
from ..parallel import mesh as pmesh
from ..testing import synthetic
from ..utils.profiling import enable_persistent_compile_cache


def _write_wav_out(wav, out_path, sr) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    audio_io.write_wav(out_path, wav, sr)


def warmup(make_synth, durations, n_iter: int = 300, whole_clip: bool = False) -> None:
    """Run the serving paths once before the first real request.

    For each duration (seconds) a synthetic MIDI + WAV pair goes through
    the same paths requests take (the tiled single-clip synthesis, the
    dynamic batch and optionally the whole clip), so first-touch costs
    (cuDNN's algorithm search for new shapes, the caching allocator's
    growth, pinned host buffers) land at start-up instead of in a user's
    request.
    """
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="mmst_warmup_") as tmp:
        for k, dur in enumerate(durations):
            t0 = time.perf_counter()
            notes = synthetic.random_song(rng, duration=float(dur))
            mp = os.path.join(tmp, f"warm{k}.mid")
            wp = os.path.join(tmp, f"warm{k}.wav")
            midi_writer.save(mp, notes)
            audio_io.write_wav(wp, rng.standard_normal(
                int(float(dur) * 44100)).astype(np.float32) * 0.1, 44100)
            synth = make_synth(mp, wp)
            synth.synthesize_waveform(n_iter=n_iter)
            bulk.batch_synthesize_waveforms([synth, make_synth(mp, wp)], n_iter=n_iter)
            if whole_clip:
                synth.synthesize_whole_clip(n_iter=n_iter)
            print(f"warmup {dur}s: {time.perf_counter() - t0:.1f}s "
                  f"(whole_clip={whole_clip})", file=sys.stderr)


def _serve_batch(make_synth, req, mesh=None, write: bool = True) -> dict:
    """One dynamic batch: every item queued on the card before the first is
    fetched (per-item error isolation inside
    ``bulk.batch_synthesize_waveforms``); over ``mesh``'s ranks where given,
    each rank leaving out the items that any rank could not build.
    ``write=False`` (the ranks other than 0) writes no file."""
    items = req["batch"]
    built, errors = {}, {}
    for i, it in enumerate(items):
        try:
            built[i] = make_synth(it["midi"], it["audio"])
        except Exception as e:  # noqa: BLE001 — per-item isolation at construction too
            errors[i] = f"{type(e).__name__}: {e}"
    if mesh is not None:
        errors = _agree_items(errors)
    results = [None] * len(items)
    for i, err in errors.items():
        results[i] = {"ok": False, "error": err}
    idx_map = [i for i in range(len(items)) if i not in errors]  # position in `synths`
    synths = [built[i] for i in idx_map]
    wavs, errors = _on_mesh(mesh, lambda: bulk.batch_synthesize_waveforms(
        synths, n_iter=int(req.get("n_iter", 300)),
        overlap=bool(req.get("overlap", True)),
        cond_mode=req.get("cond_mode", "aligned"), mesh=mesh))
    for j, i in enumerate(idx_map):
        if errors[j] is not None:
            results[i] = {"ok": False, "error": errors[j]}
            continue
        try:  # one unwritable "out" must not discard the other items
            if write:
                _write_wav_out(wavs[j], items[i]["out"], synths[j].hp.sr)
            results[i] = {"ok": True, "out": items[i]["out"]}
        except Exception as e:  # noqa: BLE001 — per-request isolation
            results[i] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    return {"ok": True, "batch": results}


def _prepare_whole(make_synth, req, mesh=None):
    """A whole-clip request's synthesizer and, on a mesh, its
    ``prepare_whole_clip``: the file reads and checks, which wait on no
    other rank."""
    synth = make_synth(req["midi"], req["audio"])
    if mesh is None:
        return synth, None
    return synth, synth.prepare_whole_clip(
        mesh, "data", shard_gl=req.get("shard_gl"), gl_halo=int(req.get("gl_halo", 32)),
        gl_rounds=int(req.get("gl_rounds", 10)))


def _whole_clip(synth, prepared, req, mesh=None):
    """A whole-clip request's waveform (time-sharded over ``mesh``'s
    ranks where given, from ``prepared``)."""
    return _on_mesh(mesh, lambda: synth.synthesize_whole_clip(
        n_iter=int(req.get("n_iter", 300)), prepared=prepared))


class MeshFault(RuntimeError):
    """A request failed on this rank after the serving mesh's ranks had
    agreed to run it. The other ranks may wait for it in a collective for
    good, so serving stops on this rank (and, under torchrun, on all)."""


def _on_mesh(mesh, fn):
    """``fn()``, the part of a request that runs collectives on ``mesh``:
    an exception there is a ``MeshFault``."""
    if mesh is None:
        return fn()
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — re-raised as the mesh's fault
        raise MeshFault(f"{type(e).__name__}: {e}") from e


def _broadcast(obj):
    """Rank 0 sends ``obj`` to every rank; the others receive it."""
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def _agree(err: str | None) -> str | None:
    """Every rank's error of a request's preparation (None where it
    succeeded), joined with the rank that raised it; None when all
    succeeded. Every rank of the serving mesh calls it at the same point,
    before the request's first collective, so all run the request or all
    skip it."""
    errs = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(errs, err)
    return "; ".join(f"rank {r}: {e}" for r, e in enumerate(errs) if e is not None) or None


def _agree_items(errors: dict) -> dict:
    """``_agree`` per batch item: {item: error} of every rank, merged (rank
    0's error, else the first rank's, named)."""
    parts = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(parts, errors)
    merged: dict = {}
    for r, part in enumerate(parts):
        for i, err in part.items():
            merged.setdefault(i, err if r == 0 else f"rank {r}: {err}")
    return merged


def follow(make_synth, mesh) -> int:
    """The loop of a rank other than 0 on a serving mesh: run each batch or
    whole-clip request rank 0 sends with it (writing nothing) until rank 0
    sends None. Returns the number of requests run. A request that a rank
    cannot prepare is skipped by all (``_agree``); a ``MeshFault`` ends the
    loop with the exception."""
    n = 0
    rank = torch.distributed.get_rank()
    while True:
        msg = _broadcast(None)
        if msg is None:
            return n
        kind, req = msg
        try:
            if kind == "batch":
                _serve_batch(make_synth, req, mesh, write=False)
            else:
                try:
                    synth, prepared = _prepare_whole(make_synth, req, mesh)
                    err = None
                except Exception as e:  # noqa: BLE001 — reported to rank 0
                    err = f"{type(e).__name__}: {e}"
                if _agree(err) is None:
                    _whole_clip(synth, prepared, req, mesh)
                elif err is not None:
                    print(f"rank {rank}: whole-clip request skipped: {err}", file=sys.stderr)
        except MeshFault as e:
            print(f"rank {rank}: {kind} request failed on the mesh: {e}", file=sys.stderr)
            raise
        except Exception as e:  # noqa: BLE001 — failed alike on every rank; rank 0 answers
            print(f"rank {rank}: {kind} request failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
        n += 1


def serve_loop(make_synth, in_stream, out_stream, pipeline_depth: int = 2, mesh=None) -> int:
    """Handle requests until EOF/'quit'. Returns the number served.

    ``make_synth(midi, audio)`` returns an ``AudioSynthesizer`` for the
    request's sources; the module-level model cache makes repeat
    construction cheap (no re-read, no re-upload).

    The reader thread (the caller's) does the host work and queues the
    card's work; the completer thread waits for results, writes WAVs and
    emits responses in request order. ``pipeline_depth`` bounds the queued
    requests (their device buffers stay allocated until fetched); 0 makes
    the reader wait until the completer has answered each request. Batch
    and whole-clip requests run in the completer as one unit each, still
    in order and isolated per request.

    Threads: ``torch.inference_mode`` is thread-local, so the synthesizer's
    device methods enter it themselves in whichever thread runs them. Both
    threads queue work on the card's one stream; a completer ``fetch()``
    waits on an event recorded right after its own request's work, so it
    never waits for requests queued after it (``synthesize._fetch_async``).

    ``mesh``: this is rank 0 of a serving mesh whose other ranks run
    ``follow``. The completer sends each batch and whole-clip request to
    them just before running it (so every collective of a request runs in
    that one thread, in order), and None when the loop ends. Before a
    request's first collective every rank reports whether it could prepare
    it, and all skip it if one could not (rank 0 answers with the error).
    A ``MeshFault`` (a failure after that point) is answered, then the
    loop stops reading and raises it.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, pipeline_depth))
    served = 0
    fatal: list = []  # the MeshFault that stopped serving
    lock = threading.Lock()  # guards `served` (completer) vs return (reader)

    def emit(resp: dict, t0: float, n_ok: int) -> None:
        nonlocal served
        resp["seconds"] = round(time.perf_counter() - t0, 3)
        with lock:
            served += n_ok
        out_stream.write(json.dumps(resp) + "\n")
        out_stream.flush()

    def completer() -> None:
        while True:
            item = q.get()
            try:
                if item is None:
                    if mesh is not None and not fatal:
                        _broadcast(None)
                    return
                kind, payload, t0 = item
                if kind == "resp":  # parse/dispatch-time error, pre-built
                    emit(payload, t0, 0)
                    continue
                if fatal:
                    emit({"ok": False, "error": f"serving stopped: {fatal[0]}"}, t0, 0)
                    continue
                if kind == "thunk":  # batch / whole clip
                    try:
                        resp = payload()
                        n_ok = (sum(r["ok"] for r in resp["batch"])
                                if "batch" in resp else int(resp["ok"]))
                    except MeshFault as e:
                        fatal.append(e)
                        resp = {"ok": False, "error": f"the serving mesh failed: {e}"}
                        n_ok = 0
                    except Exception as e:  # noqa: BLE001 — isolation
                        resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                        n_ok = 0
                    emit(resp, t0, n_ok)
                    continue
                # kind == "fetch": wait for the queued device result
                fetch, out_path, sr = payload
                try:
                    wav = fetch()
                    _write_wav_out(wav, out_path, sr)
                    dt = time.perf_counter() - t0
                    resp = {"ok": True, "out": out_path,
                            "realtime_x": round(len(wav) / sr / dt, 2)}
                    n_ok = 1
                except Exception as e:  # noqa: BLE001 — isolation
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    n_ok = 0
                emit(resp, t0, n_ok)
            finally:
                q.task_done()

    worker = threading.Thread(target=completer, name="serve-completer", daemon=True)
    worker.start()
    try:
        for line in in_stream:
            line = line.strip()
            if not line:
                continue
            if line == "quit":
                break
            t0 = time.perf_counter()
            try:
                req = json.loads(line)
                if "batch" in req:
                    def run_batch(req=req):
                        if mesh is not None:
                            _broadcast(("batch", req))
                        return _serve_batch(make_synth, req, mesh)

                    q.put(("thunk", run_batch, t0))
                else:
                    n_iter = int(req.get("n_iter", 300))
                    if req.get("whole_clip"):
                        synth, prepared = _prepare_whole(make_synth, req, mesh)

                        def run_whole(synth=synth, prepared=prepared, req=req):
                            if mesh is not None:
                                _broadcast(("whole", req))
                                err = _agree(None)
                                if err is not None:
                                    return {"ok": False, "error": err}
                            wav = _whole_clip(synth, prepared, req, mesh)
                            _write_wav_out(wav, req["out"], synth.hp.sr)
                            return {"ok": True, "out": req["out"]}

                        q.put(("thunk", run_whole, t0))
                    else:
                        synth = make_synth(req["midi"], req["audio"])
                        # the hot path: host prep and queueing here, the
                        # wait and the WAV write in the completer
                        fetch = synth.synthesize_waveform_async(
                            n_iter=n_iter, overlap=bool(req.get("overlap", True)),
                            cond_mode=req.get("cond_mode", "aligned"))
                        q.put(("fetch", (fetch, req["out"], synth.hp.sr), t0))
            except Exception as e:  # noqa: BLE001 — per-request isolation at dispatch
                q.put(("resp", {"ok": False, "error": f"{type(e).__name__}: {e}"}, t0))
            if pipeline_depth == 0:
                q.join()
            if fatal:
                break
    finally:
        q.put(None)
        worker.join()
    if fatal:
        raise fatal[0]
    with lock:
        return served


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-exp-name", dest="exp_name", required=True)
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--use-ema", action="store_true",
                    help="serve the EMA weights a run with --ema-decay checkpointed")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--exp-root", default="./experiments")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="ranks of the serving mesh (under torchrun, one per card): batch "
                         "requests split over them, whole clips shard their time axis")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="max queued requests: host prep of request N+1 overlaps the "
                         "card's work on request N (0 = serial)")
    ap.add_argument("--warmup", default="",
                    help="comma-separated clip durations (seconds) to run once at "
                         "start-up, e.g. '10,30'; '' disables")
    ap.add_argument("--warmup-whole-clip", action="store_true",
                    help="also run the whole-clip path per --warmup duration")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh_data > 1:
        mesh = pmesh.make_mesh(args.mesh_data, 1, device=args.device)
        device = pmesh.mesh_device(mesh)
    else:
        device = resolve_device(args.device)
    # no request pays for nvcc: every kernel is built before stdin is read
    build_dir = enable_persistent_compile_cache(device)
    if build_dir:
        print(f"kernels built in {build_dir}", file=sys.stderr)

    exp_dir = os.path.join(os.path.abspath(args.exp_root), args.exp_name)
    cfg = ModelConfig(width_mult=args.width_mult)

    def make_synth(midi, audio):
        return AudioSynthesizer(exp_dir, midi, audio, model_cfg=cfg,
                                checkpoint_path=args.checkpoint, use_ema=args.use_ema,
                                device=device)

    if mesh is not None and torch.distributed.get_rank() != 0:
        n = follow(make_synth, mesh)
        print(f"rank {torch.distributed.get_rank()} ran {n} mesh requests", file=sys.stderr)
        return n
    if args.warmup:
        warmup(make_synth, [float(d) for d in args.warmup.split(",") if d.strip()],
               whole_clip=args.warmup_whole_clip)
    print(f"serving {exp_dir} (width_mult={args.width_mult}, device={device}); "
          "one JSON request per line, 'quit' or EOF to stop", file=sys.stderr)
    n = serve_loop(make_synth, sys.stdin, sys.stdout, pipeline_depth=args.pipeline_depth,
                   mesh=mesh)
    print(f"served {n} requests", file=sys.stderr)
    return n


if __name__ == "__main__":
    main()
