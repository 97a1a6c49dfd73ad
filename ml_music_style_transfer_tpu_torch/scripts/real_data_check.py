"""Real-data readiness check, preprocess -> train -> synthesize: the
counterpart of the root ``scripts/real_data_check.py``.

Point it at a MusicNet-style directory (``{id}*mixcraft.mid`` beside
``{id}_..._{style}.wav``, the reference's naming contract) and it

  1. preprocesses the directory end to end: into memory
     (``data/preprocess.get_arrays``, no h5py needed), or with ``--workdir
     DIR`` into ``DIR/ds_train.hdf5`` (``get_data``, needs h5py), read back
     through ``ChunkDataset``; the directory is kept,
  2. checks the chunk-alignment and shape contracts,
  3. takes ``--steps`` train steps and requires the loss to descend,
  4. synthesizes one chunk (forward + Griffin-Lim) and reports the
     Griffin-Lim spectral error of its waveform,

then prints a JSON report (and writes it to ``--out`` where given); it
exits 1 where a check that ran did not pass.
MusicNet is not shipped with this repository: ``--synthetic`` writes a
seeded directory of that shape with ``testing/synthetic.make_dataset_dir``
(under ``--workdir`` where given) and checks that; with neither a
directory nor ``--synthetic`` it reports ``"skipped": true`` and exits 0.

    python -m ml_music_style_transfer_tpu_torch.scripts.real_data_check \
        --data-dir /path/to/musicnet_styles [--width-mult 0.25] [--steps 60] \
        [--batch-size 4] [--n-iter 100] [--workdir DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import DEFAULT_DSP, ModelConfig, TrainConfig
from ..data import preprocess as pp
from ..data.dataset import ChunkDataset
from ..device import resolve_device
from ..ops import griffinlim as gl
from ..ops import stft
from ..testing import synthetic
from ..train.loop import Trainer, device_prefetch

SEED = 0  # the synthetic directory, the draw order and the initial weights


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=os.environ.get("MMST_REAL_DATA_DIR"),
                    help="MusicNet-style dir of {id}*mixcraft.mid + {id}_..._{style}.wav")
    ap.add_argument("--synthetic", action="store_true",
                    help="check a seeded synthetic directory of that shape instead")
    ap.add_argument("--width-mult", type=float, default=0.25,
                    help="model width for the smoke-train (1.0 = flagship)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-iter", type=int, default=100, help="Griffin-Lim iterations")
    ap.add_argument("--max-chunks-per-song", type=int, default=100)
    ap.add_argument("--workdir", default=None,
                    help="preprocess into DIR/ds_train.hdf5 (needs h5py) and keep it; "
                         "default: in memory")
    ap.add_argument("--out", default=None, help="also write the JSON report here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    hp = DEFAULT_DSP

    if args.workdir and importlib.util.find_spec("h5py") is None:
        raise ImportError("--workdir writes the dataset as HDF5 and needs h5py; without "
                          "--workdir the check preprocesses into memory")
    work = args.workdir or tempfile.mkdtemp(prefix="mmst_real_data_")
    try:
        data_dir = args.data_dir
        if args.synthetic:
            data_dir = synthetic.make_dataset_dir(os.path.join(work, "songs"), song_ids=[1, 2],
                                                  styles=["cuba", "upright"], duration=16.0,
                                                  seed=SEED)
        if not data_dir or not os.path.isdir(data_dir):
            return _finish({"skipped": True,
                            "reason": "no --data-dir / MMST_REAL_DATA_DIR and no --synthetic "
                                      "(MusicNet is not shipped with this repo)"}, args.out)
        song_ids, styles = pp.discover_song_ids(data_dir), pp.discover_styles(data_dir)
        if not song_ids or not styles:
            return _finish({"skipped": True,
                            "reason": f"{data_dir} has no {{id}}*mixcraft.mid / "
                                      f"{{id}}_*_{{style}}.wav pairs"}, args.out)
        log(f"discovered songs={song_ids} styles={styles}")

        # 1) preprocess (the reference's pipeline, preprocess.py:163-232)
        t0 = time.perf_counter()
        if args.workdir:
            dataset = pp.get_data(data_dir, os.path.join(work, "ds"), "train",
                                  song_ids=song_ids, styles=styles,
                                  max_chunks=args.max_chunks_per_song, device=dev)
            t_pre = time.perf_counter() - t0
            ds = ChunkDataset(dataset, seed=SEED)
        else:
            raw = pp.get_arrays(data_dir, "train", song_ids=song_ids, styles=styles,
                                max_chunks=args.max_chunks_per_song, device=dev)
            t_pre = time.perf_counter() - t0
            dataset = None
            ds = ChunkDataset.from_arrays(raw, seed=SEED, source=data_dir)
    finally:
        if not args.workdir:
            shutil.rmtree(work, ignore_errors=True)

    # 2) alignment and shape contracts
    if ds.n_data == 0:
        raise ValueError("preprocessing produced zero chunks")
    roll_shape = (hp.windows_per_chunk, 128)
    if ds.pianoroll.shape[1:] != roll_shape or ds.onoff.shape != ds.pianoroll.shape:
        raise ValueError(f"roll shapes {ds.pianoroll.shape}, {ds.onoff.shape}")
    for s, spec in ds.specs.items():
        if spec.shape != (ds.n_data, hp.windows_per_chunk, hp.n_freq_bins):
            raise ValueError(f"{s}: spectrogram shape {spec.shape}")
    if not set(np.unique(ds.pianoroll)) <= {0.0, 1.0}:
        raise ValueError("the piano roll is not binary")
    log(f"contracts OK: {ds.n_data} chunks x {len(ds.specs)} styles ({t_pre:.1f} s)")

    # 3) train steps: the loss must descend
    bs = min(args.batch_size, ds.n_data)
    # bf16 compute on the card; float32 on the CPU, where bf16 convs are slow
    dtype = "bfloat16" if dev.type == "cuda" else "float32"
    tr = Trainer(ModelConfig(width_mult=args.width_mult, compute_dtype=dtype),
                 TrainConfig(batch_size=bs, learning_rate=args.lr, seed=SEED), device=dev)
    tr.init_state(SEED)
    losses = []
    t0 = time.perf_counter()
    while len(losses) < args.steps:
        for batch in device_prefetch(ds.epoch_batches(bs, shuffle=True, drop_last=True), dev):
            losses.append(tr.train_step(batch, tr.next_dropout_seed()))
            if len(losses) >= args.steps:
                break
    losses = torch.stack(losses).tolist()
    t_train = time.perf_counter() - t0
    k = max(1, args.steps // 10)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    log(f"train L1: first{k}={first:.4f} last{k}={last:.4f} ({t_train:.1f} s)")

    # 4) one synthesis: a chunk through the model, then Griffin-Lim
    style = ds.styles[0]
    with torch.no_grad():
        pred = tr.model(*(torch.from_numpy(a[:1]).to(dev)
                          for a in (ds.pianoroll, ds.specs[style], ds.onoff)))[0]
    spec = pred.float().transpose(0, 1)  # (1025, 860)
    wav = gl.griffinlim_from_log_power(spec, n_iter=args.n_iter, device=dev)
    finite = bool(torch.isfinite(wav).all()) and float(wav.abs().max()) > 0
    got = stft.log_power_stft(wav[: hp.samples_per_chunk], hp.n_fft, hp.ws)
    mag_pred = stft.inverse_log_power(spec)
    mag_got = stft.inverse_log_power(got[:, : mag_pred.shape[1]])
    gl_rel = float(torch.linalg.vector_norm(mag_got - mag_pred)
                   / torch.linalg.vector_norm(mag_pred).clamp(min=1e-9))
    log(f"synthesis: finite={finite} GL rel={gl_rel:.3f}")
    return _finish({
        "skipped": False,
        "data_dir": "synthetic" if args.synthetic else os.path.abspath(data_dir),
        "dataset": os.path.abspath(dataset) if dataset else "memory",
        "songs": song_ids,
        "styles": styles,
        "n_chunks": int(ds.n_data),
        "preprocess_sec": t_pre,
        "width_mult": args.width_mult,
        "steps": args.steps,
        "batch_size": bs,
        "train_l1_first": first,
        "train_l1_last": last,
        "train_sec": t_train,
        "gl_rel_err": gl_rel,
        "synth_finite": finite,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "passed": bool(last < first and finite and gl_rel < 0.8),
    }, args.out)


def _finish(result: dict, out: str | None) -> dict:
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    report = main()
    sys.exit(0 if report["skipped"] or report["passed"] else 1)
