"""Trained-model quality gate on the card: the port's counterpart of the
JAX package's ``scripts/quality_gate_tpu.py`` (its canonical gate).

    python -m ml_music_style_transfer_tpu_torch.scripts.quality_gate \\
        [--styles 2|5] [--epochs 2000] [--seed 0] [--alpha 0.25] \\
        [--width-mult 1.0] [--batch-size 16] [--lr 1e-3] [--device cuda]

Renders a synthetic dataset (``testing/synthetic.make_dataset_dir``: song
ids 11 and 12, 60 s each, RMS-normalized, dataset seed 8; styles
gentleman and harpsichord, or all five with ``--styles 5``), preprocesses
it with the port's pipeline keeping the raw audio (``get_arrays`` with
``store_audio``, in memory), parks it on the device as a float32
``DeviceDataStore`` and trains a PerformanceNet (full width, bfloat16
compute, float32 Adam at ``--lr``) with resident steps: per epoch the
chunks but the last, shuffled, in batches of ``--batch-size``, each item's
conditioning a random training chunk of the same style. Then it checks
the learned style transfer:

  - the L1 confusion matrix on the held-out last chunk: the prediction
    conditioned on style s (train chunk 0's audio: right timbre, wrong
    notes) against each style's target, beside the targets' own
    separation; each style must turn at least ``alpha`` of every pair's
    separation into margin (``testing/quality.discrimination_report``);
  - training must at least halve the L1 (first ten steps against the last
    ten);
  - aligned conditioning must beat centre-crop conditioning on a 15 s clip
    whose middle 5 s carry the other style's timbre;
  - the Griffin-Lim floor: 100 iterations on the predicted spectrogram
    (through the glue kernels on the card), whose magnitude must come back
    within 0.6 relative error.

It writes ``QUALITY_GATE_H100.json`` at the repository root (other widths,
seeds and ``--styles 5`` get suffixed names; ``--device cpu`` writes
``QUALITY_GATE_CPU*.json``), never a TPU artifact, and prints it as its
last line. The bar is pass/fail. The JAX script's spectral-loss and
whole-clip-divergence options raise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import DEFAULT_DSP, ModelConfig, TrainConfig
from ..data import audio_io, preprocess
from ..data.device_store import DeviceDataStore
from ..device import resolve_device
from ..infer.synthesize import AudioSynthesizer
from ..midi import writer as midi_writer
from ..ops import griffinlim as tgl
from ..ops import stft as tstft
from ..ops.kernels import dropout as dk
from ..ops.kernels import gl_glue
from ..testing import quality, synthetic
from ..train.loop import Trainer
from .bench_inference import smi_line

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SWEEP_ITEM = "ROADMAP queue 1 item 10 (support code: quality-gate sweeps)"
SONG_IDS = (11, 12)
SONG_SECONDS = 60.0
DATASET_SEED = 8
GL_ITERS = 100
GL_FLOOR = 0.6


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def artifact_name(args, device: torch.device) -> str:
    name = "QUALITY_GATE_H100.json" if device.type == "cuda" else "QUALITY_GATE_CPU.json"
    if args.styles == 5:
        name = name.replace(".json", "_5STYLE.json")
    if args.width_mult != 1.0:
        w = f"{args.width_mult:g}".replace(".", "p")
        name = name.replace(".json", f"_W{w}.json")
    if args.seed != 0:
        name = name.replace(".json", f"_SEED{args.seed}.json")
    return name


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--styles", type=int, choices=(2, 5), default=2,
                    help="2 = gentleman and harpsichord (the canonical gate); 5 = all "
                         "reference styles, a 5x5 confusion matrix")
    ap.add_argument("--seed", type=int, default=0,
                    help="training randomness (init, shuffle, cond/style draws, dropout); "
                         "the dataset stays fixed")
    ap.add_argument("--alpha", type=float, default=quality.DEFAULT_ALPHA,
                    help="share of each pair's target separation that must show as "
                         "prediction margin (testing/quality.py)")
    ap.add_argument("--spectral-loss-weight", type=float, default=0.0,
                    help="not run by the port's gate yet")
    ap.add_argument("--spectral-loss-mode", choices=("linlog", "log", "direct"),
                    default="linlog", help="not run by the port's gate yet")
    ap.add_argument("--wholeclip-divergence", action="store_true",
                    help="not run by the port's gate yet")
    ap.add_argument("--out-dir", default=REPO_ROOT,
                    help="where the JSON artifact is written (default: the repository root)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (checks the script "
                         "at a small width; gate results count on the card)")
    return ap


def train(tr: Trainer, store: DeviceDataStore, args) -> tuple[list[float], float]:
    """Resident training over every chunk but the last; returns the step
    losses and the training seconds."""
    b = args.batch_size
    train_idx = np.arange(store.n_data - 1)
    host_rng = np.random.default_rng(args.seed)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        host_rng.shuffle(train_idx)
        for s in range(0, len(train_idx) - b + 1, b):
            idx = train_idx[s:s + b]
            cond_idx = host_rng.choice(train_idx, size=b)  # training chunks only
            style = host_rng.integers(0, len(store.styles), b)
            losses.append(tr.train_step_resident(
                store.audio, store.pianoroll, store.onoff, store.put_idx(idx),
                store.put_idx(cond_idx), store.put_idx(style), tr.next_dropout_seed()))
        if epoch == 0 or (epoch + 1) % 50 == 0:
            log(f"epoch {epoch + 1}: loss={float(losses[-1]):.4f} "
                f"({time.perf_counter() - t0:.0f}s)")
    out = torch.stack(losses).tolist()
    return out, time.perf_counter() - t0


@torch.inference_mode()
def probe(tr: Trainer, store: DeviceDataStore):
    """The held-out chunk's L1 confusion matrix m[s, t] (prediction
    conditioned on style s against the style-t target), the targets' own
    separation, and the predictions."""
    hp = DEFAULT_DSP
    held = store.n_data - 1

    def spec_of(s, c):
        a = store.audio[s, c].float()
        return tstft.log_power_stft(a, hp.n_fft, hp.ws).transpose(0, 1)

    roll = store.pianoroll[held][None].float()
    onoff = store.onoff[held][None].float()
    preds, targets = [], []
    for s in range(len(store.styles)):
        preds.append(tr.model(roll, spec_of(s, 0)[None], onoff, deterministic=True)[0].float())
        targets.append(spec_of(s, held))
    m = np.array([[float((p - t).abs().mean()) for t in targets] for p in preds])
    tsep = np.array([[float((a - t).abs().mean()) for t in targets] for a in targets])
    return m, tsep, preds


def cond_proof(tr: Trainer, styles, root: str, device: torch.device) -> tuple[float, float]:
    """L1 of the aligned and the centre-crop conditioning against the
    spliced clip's own spectrogram (the MIDI is the same): a 15 s clip in
    style B with style A's rendering in its middle 5 s."""
    hp = DEFAULT_DSP
    rng = np.random.default_rng(99)
    dur = 15.0
    notes = synthetic.random_song(rng, duration=dur)
    wav_a = synthetic.render_notes(notes, styles[0], hp.sr, dur, normalize="rms")
    spliced = synthetic.render_notes(notes, styles[1], hp.sr, dur, normalize="rms")
    mid = slice((len(spliced) - 5 * hp.sr) // 2, (len(spliced) - 5 * hp.sr) // 2 + 5 * hp.sr)
    spliced[mid] = wav_a[mid]
    midi_path, wav_path = os.path.join(root, "proof.mid"), os.path.join(root, "proof.wav")
    midi_writer.save(midi_path, notes)
    audio_io.write_wav(wav_path, spliced, hp.sr)
    synth = AudioSynthesizer(root, midi_path, wav_path, model_cfg=tr.model_cfg,
                             params=tr.model.state_dict(), device=device)
    with torch.inference_mode():
        target = tstft.log_power_stft(tstft.to_device(torch.from_numpy(spliced), device),
                                      hp.n_fft, hp.ws).transpose(0, 1)
        out = []
        for mode in ("aligned", "center"):
            spec, t_tot = synth._predict_device(midi_path, wav_path, overlap=True, cond_mode=mode)
            t = min(t_tot, target.shape[0])
            out.append(float((spec[:t].float() - target[:t]).abs().mean()))
    return out[0], out[1]


def gl_floor(pred: torch.Tensor, device: torch.device) -> tuple[bool, float]:
    """Griffin-Lim of the (860, 1025) predicted log-power spectrogram:
    whether the waveform is finite and non-zero, and the relative L2 error
    of its magnitude against the predicted one."""
    hp = DEFAULT_DSP
    with torch.inference_mode():
        spec = pred.transpose(0, 1).contiguous()
        wav = tgl.griffinlim_from_log_power(spec, n_iter=GL_ITERS, device=device)
        finite = bool(torch.isfinite(wav).all()) and float(wav.abs().max()) > 0
        mag_pred = tstft.inverse_log_power(spec)
        got = tstft.log_power_stft(wav[:hp.samples_per_chunk], hp.n_fft, hp.ws)
        mag_got = tstft.inverse_log_power(got[:, :mag_pred.shape[1]])
        rel = float(torch.linalg.vector_norm(mag_got - mag_pred)
                    / max(float(torch.linalg.vector_norm(mag_pred)), 1e-9))
    return finite, rel


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.spectral_loss_weight > 0 or args.spectral_loss_mode != "linlog":
        raise NotImplementedError(f"--spectral-loss-weight/--spectral-loss-mode wait for "
                                  f"{SWEEP_ITEM}")
    if args.wholeclip_divergence:
        raise NotImplementedError(f"--wholeclip-divergence waits for {SWEEP_ITEM}")
    dev = resolve_device(args.device)
    smi = smi_line() if dev.type == "cuda" else None
    if smi:
        log(smi)
    styles = (["gentleman", "harpsichord"] if args.styles == 2
              else list(synthetic.STYLE_TIMBRES))
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mmst_qgate_") as root:
        synthetic.make_dataset_dir(os.path.join(root, "raw"), song_ids=SONG_IDS, styles=styles,
                                   duration=SONG_SECONDS, seed=DATASET_SEED, normalize="rms")
        raw = preprocess.get_arrays(os.path.join(root, "raw"), "train", song_ids=SONG_IDS,
                                    styles=styles, store_audio=True, write_spectrum=False,
                                    device=dev)
        store = DeviceDataStore.from_arrays(raw, seed=args.seed, audio_dtype=torch.float32,
                                            device=dev)
        del raw
        log(f"dataset: {store.n_data} chunks x {store.styles}, "
            f"{store.hbm_bytes() / 1e9:.3f} GB on {dev}")

        model_cfg = ModelConfig(width_mult=args.width_mult)
        tr = Trainer(model_cfg, TrainConfig(batch_size=args.batch_size,
                                            learning_rate=args.lr, seed=args.seed),
                     device=dev)
        tr.init_state(args.seed)
        n_params = sum(p.numel() for p in tr.model.parameters())
        log(f"params: {n_params / 1e6:.1f}M (width_mult={args.width_mult})")
        dk.reset_launches()
        losses, train_s = train(tr, store, args)
        dropout_launches = dict(dk.LAUNCHES)
        first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        log(f"train L1: first10={first10:.4f} last10={last10:.4f} ({len(losses)} steps, "
            f"{train_s:.1f}s)")

        m, tsep, preds = probe(tr, store)
        report = quality.discrimination_report(m, tsep, alpha=args.alpha)
        per_style = report["per_style_discrimination"]
        for s, name in enumerate(store.styles):
            log(f"held-out L1 — cond {name}: own={m[s, s]:.4f} "
                f"best-other={np.delete(m[s], s).min():.4f} "
                f"min-norm-margin={report['per_style_min_normalized_margin'][s]:.3f} "
                f"(alpha={args.alpha}) disc={per_style[s]}")
        l_aligned, l_center = cond_proof(tr, styles, root, dev)
        log(f"cond proof: aligned L1={l_aligned:.4f} center L1={l_center:.4f}")
        gl_gl = dict(gl_glue.LAUNCHES)
        finite, gl_rel = gl_floor(preds[1], dev)
        gl_launches = {k: gl_glue.LAUNCHES[k] - gl_gl[k] for k in gl_gl}
        log(f"GL floor: finite={finite} rel={gl_rel:.3f} launches={gl_launches}")

    result = {
        "device": {"kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "name_power_limit": smi},
        "width_mult": args.width_mult,
        "params_m": round(n_params / 1e6, 1),
        "epochs": args.epochs,
        "steps": len(losses),
        "batch_size": args.batch_size,
        "n_chunks": store.n_data,
        "n_styles": len(store.styles),
        "styles": list(store.styles),
        "l1_confusion": [[round(float(v), 4) for v in row] for row in m],
        "l1_target_separation": [[round(float(v), 4) for v in row] for row in tsep],
        "per_style_discrimination": per_style,
        "train_l1_first10": round(first10, 4),
        "train_l1_last10": round(last10, 4),
        "alpha": report["alpha"],
        "normalized_margins": report["normalized_margins"],
        "per_style_min_normalized_margin": report["per_style_min_normalized_margin"],
        "min_normalized_margin": report["min_normalized_margin"],
        "seed": args.seed,
        "styles_normalized": "rms",
        "cond_aligned_l1": round(l_aligned, 4),
        "cond_center_l1": round(l_center, 4),
        "aligned_beats_center": bool(l_aligned < l_center),
        "gl_iters": GL_ITERS,
        "gl_rel_err": round(gl_rel, 4),
        "gl_finite": finite,
        "launches": {"dropout": dropout_launches, "gl_glue": gl_launches},
        "train_seconds": round(train_s, 1),
        "total_seconds": round(time.perf_counter() - t_start, 1),
        "passed": bool(all(per_style) and finite and gl_rel < GL_FLOOR
                       and last10 < 0.5 * first10 and l_aligned < l_center),
    }
    out = os.path.join(args.out_dir, artifact_name(args, dev))
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    log(f"wrote {out}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
