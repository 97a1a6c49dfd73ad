"""Preprocessing wall time end to end, files -> dataset, on the card.

    python -m ml_music_style_transfer_tpu_torch.scripts.bench_preprocess \\
        [--songs 4] [--duration 90] [--styles cuba upright] [--seed 0] \\
        [--out PREPROCESS_BENCH_H100.json] [--device cuda]

The port's counterpart of the JAX package's ``scripts/bench_preprocess.py``.
A seeded synthetic directory (``testing/synthetic.make_dataset_dir``:
``--songs`` songs, ``--duration`` seconds of audio per (song, style) file)
goes through ``data/preprocess.get_arrays`` (threaded decode-ahead, batched
STFT), timed on the host clock, in these runs:

  - the device STFT, cold (the first call in the process) then warm;
  - warm with ``prefetch=False`` (decode and STFT in turn);
  - the host backend (the NumPy reference STFT);
  - ``auto`` after clearing ``_AUTO_BACKEND_CACHE`` (its probe inside the
    time), which must be at most 1.25x the best manual run, or the script
    exits non-zero after writing its JSON;
  - ``store_audio=True, write_spectrum=False`` (the device-resident
    training build);
  - the reference-shaped emulation: serial decode, then a per-chunk NumPy
    STFT (``ops/reference.py``) per chunk, as the reference's
    preprocess.py:60-77 loop.

Both sides run ``get_arrays``, not ``get_data``: the same pipeline
(``_preprocess_into``) into memory instead of an HDF5 file, since the
card's machine has no h5py (``"sink": "memory"`` in the JSON). The content
check is the largest |spectrogram difference| between the warm run and the
emulation. The JSON carries the JAX script's keys, the card's name and
power limit, and is written to ``--out``. ``--device cpu`` checks the
script on the CPU; its numbers are CPU numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import DEFAULT_DSP
from ..data import chunking
from ..data import preprocess as pp
from ..data.hdf5_store import ArrayStore
from ..device import resolve_device
from ..ops import reference as npref
from ..testing import synthetic
from .bench_inference import smi_line

AUTO_LIMIT = 1.25  # auto's wall time over the best manual backend's


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def reference_emulated(data_dir: str, song_ids, styles, hp=DEFAULT_DSP) -> dict:
    """The reference's get_data loop shape (preprocess.py:163-232): serial
    decode, one host STFT per chunk (preprocess.py:47-77), the same arrays
    as ``get_arrays``."""
    store = ArrayStore()
    for song_id in song_ids:
        roll, onoff = pp.load_midi(data_dir, song_id, hp=hp)
        n = chunking.num_song_chunks(roll.shape[0], hp)
        store.write_pianoroll(chunking.chunk_pianoroll(roll, n, hp),
                              chunking.chunk_pianoroll(onoff, n, hp))
        for style in styles:
            try:
                audio = pp.load_audio(data_dir, song_id, style, hp)
            except FileNotFoundError:
                continue
            chunks = chunking.chunk_audio(audio, n, hp)
            specs = (np.stack([npref.log_power(npref.stft(c, hp.n_fft, hp.ws)) for c in chunks])
                     if n else np.zeros((0, hp.n_freq_bins, hp.windows_per_chunk), np.float32))
            store.write_spectrum(specs.astype(np.float32), style)
    return store.arrays()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--songs", type=int, default=4)
    ap.add_argument("--duration", type=float, default=90.0,
                    help="seconds of audio per (song, style) file")
    ap.add_argument("--styles", nargs="*", default=["cuba", "upright"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="PREPROCESS_BENCH_H100.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (checks the script)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = smi_line() if dev.type == "cuda" else "cpu"
    print(where, flush=True)
    hp = DEFAULT_DSP
    song_ids = [100 + i for i in range(args.songs)]
    work = tempfile.mkdtemp(prefix="mmst_bench_pp_")
    try:
        data_dir = synthetic.make_dataset_dir(os.path.join(work, "data"), song_ids=song_ids,
                                              styles=args.styles, duration=args.duration,
                                              seed=args.seed)
        wav_bytes = sum(os.path.getsize(os.path.join(data_dir, f))
                        for f in os.listdir(data_dir) if f.endswith(".wav"))
        log(f"{args.songs} songs x {args.styles} ({args.duration:g} s each): "
            f"{wav_bytes / 1e6:.1f} MB of WAVs")

        def run(**kw):
            t = time.perf_counter()
            out = pp.get_arrays(data_dir, "train", song_ids=song_ids, styles=args.styles,
                                device=dev, **kw)
            return time.perf_counter() - t, out

        cold, _ = run(stft_backend="device")
        warm, ours = run(stft_backend="device")
        serial, _ = run(stft_backend="device", prefetch=False)
        host, _ = run(stft_backend="host")
        pp._AUTO_BACKEND_CACHE.clear()
        auto, _ = run(stft_backend="auto")
        auto_resolved = pp._AUTO_BACKEND_CACHE.get(str(dev), "device")
        skip, _ = run(store_audio=True, write_spectrum=False)
        t = time.perf_counter()
        ref = reference_emulated(data_dir, song_ids, args.styles, hp)
        ref_s = time.perf_counter() - t

        if ours["pianoroll"].shape != ref["pianoroll"].shape:
            raise RuntimeError(f"piano rolls {ours['pianoroll'].shape} vs "
                               f"{ref['pianoroll'].shape}")
        key = f"spec_{args.styles[0]}"
        n_chunks = ours[key].shape[0]
        spec_err = float(np.max(np.abs(ours[key] - ref[key])))
        log(f"content check: {n_chunks} chunks, max |spec diff| = {spec_err:.2e}")
        best_manual = min(warm, host)
        result = {
            "songs": args.songs,
            "styles": args.styles,
            "duration_s_per_file": args.duration,
            "n_chunks": int(n_chunks),
            "frames_total": int(n_chunks * hp.windows_per_chunk * len(args.styles)),
            "ours_cold_s": cold,
            "ours_warm_s": warm,
            "ours_warm_serial_s": serial,
            "ours_host_backend_s": host,
            "ours_auto_backend_s": auto,
            "auto_resolved_backend": auto_resolved,
            "auto_vs_best_manual": auto / best_manual,
            "ours_skip_spectrum_s": skip,
            "reference_emulated_s": ref_s,
            "speedup_warm": ref_s / warm,
            "speedup_cold": ref_s / cold,
            "speedup_host_backend": ref_s / host,
            "speedup_skip_spectrum": ref_s / skip,
            "prefetch_gain": serial / warm,
            "spec_max_abs_diff": spec_err,
            "sink": "memory",
            "device": where,
            "torch": torch.__version__,
            "note": ("reference side is the reference's loop shape (serial decode + per-chunk "
                     "host STFT, preprocess.py:60-77) with the port's NumPy DSP "
                     "(ops/reference.py) standing in for librosa; decode and MIDI code are the "
                     "same on both sides; both sides preprocess into memory (get_arrays)"),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    if auto > AUTO_LIMIT * best_manual:
        raise SystemExit(f"auto ({auto:.2f} s via {auto_resolved!r}) is over {AUTO_LIMIT}x the "
                         f"best manual backend ({best_manual:.2f} s)")
    return result


if __name__ == "__main__":
    main()
