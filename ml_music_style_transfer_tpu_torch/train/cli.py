"""Training CLI: the reference's train.py entry point, the JAX package's
flags, plus ``--device`` (default ``cuda``; with no card it fails).

    python -m ml_music_style_transfer_tpu_torch.train.cli \
        -data-dir PATH_BASENAME -exp-name NAME [-epochs N] [-test-freq N] \
        [--batch-size N] [--n-train-read N] [--n-test-read N] [--resume] \
        [--width-mult F] [--spectral-loss W] [--stream-bf16] [--device-resident] \
        [--device D]

Reading the HDF5 dataset needs ``h5py``. ``--device-resident`` keeps the
train split on the card (a file preprocessed with ``--store-audio``) and
assembles each batch there. The flags of options the port does not run yet
(a mesh > 1, --store-sharding data, --ckpt-format msgpack/orbax, the
Adam/grad dtypes, clipping, warmup, EMA, grad-accum, ZeRO and --debug-nans)
are accepted and refused with ``NotImplementedError`` naming the ROADMAP
item that brings them. Reference CLI: model/train.py:211-220.
"""
from __future__ import annotations

import argparse

import torch

from ..config import ModelConfig, TrainConfig
from .loop import Trainer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-data-dir", dest="data_dir", type=str, required=True,
                   help="dataset basename; _train.hdf5/_test.hdf5 are appended")
    p.add_argument("-epochs", dest="epochs", type=int, default=1)
    p.add_argument("-test-freq", dest="test_freq", type=int, default=1)
    p.add_argument("-exp-name", dest="exp_name", type=str, default="piano_test")
    p.add_argument("--n-train-read", type=int, default=None)
    p.add_argument("--n-test-read", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    p.add_argument("--width-mult", type=float, default=1.0,
                   help="channel-width multiplier (1.0 = reference full size)")
    p.add_argument("--mesh-data", type=int, default=1, help="data-parallel axis size")
    p.add_argument("--mesh-model", type=int, default=1, help="tensor-parallel axis size")
    p.add_argument("--spectral-loss", type=float, default=0.0,
                   help="weight of the DDSP-style multi-scale spectral loss")
    p.add_argument("--spectral-loss-mode", choices=("linlog", "log", "direct"),
                   default="linlog", help="spectral-loss variant")
    p.add_argument("--compat-mbr-noop", action="store_true",
                   help="reproduce the reference MBRBlock no-op/doubling behavior")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on NaN (not ported yet)")
    p.add_argument("--stream-bf16", action="store_true",
                   help="upload host batches as bfloat16 (halves host->device bytes)")
    p.add_argument("--device-resident", action="store_true",
                   help="keep the train split on the device and gather each batch "
                        "there (needs preprocessing with --store-audio)")
    p.add_argument("--adam-mu-dtype", choices=("float32", "bfloat16"), default=None)
    p.add_argument("--adam-nu-dtype", choices=("float32", "bfloat16"), default=None)
    p.add_argument("--grads-dtype", choices=("float32", "bfloat16"), default=None)
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--ema-decay", type=float, default=None)
    p.add_argument("--store-sharding", choices=("replicated", "data"), default="replicated",
                   help="device-resident store placement on a mesh ('data' waits for "
                        "multi-device)")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--zero-opt", action="store_true")
    p.add_argument("--ckpt-format", choices=("torch", "msgpack", "orbax"), default="torch",
                   help="'torch': checkpoint-{epoch}.pt via torch.save (the port's "
                        "format); the JAX package's formats are not written yet")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    if args.debug_nans:
        raise NotImplementedError("--debug-nans waits for ROADMAP queue 1 item 10 (support code)")
    model_cfg = ModelConfig(width_mult=args.width_mult, compat_mbr_noop=args.compat_mbr_noop)
    train_cfg = TrainConfig(
        epochs=args.epochs, test_freq=args.test_freq, exp_name=args.exp_name,
        batch_size=args.batch_size, learning_rate=args.lr,
        n_train_read=args.n_train_read, n_test_read=args.n_test_read,
        spectral_loss_weight=args.spectral_loss,
        spectral_loss_mode=args.spectral_loss_mode,
        mesh_shape=(args.mesh_data, args.mesh_model),
        adam_mu_dtype=args.adam_mu_dtype,
        adam_nu_dtype=args.adam_nu_dtype,
        grads_dtype=None if args.grads_dtype == "float32" else args.grads_dtype,
        grad_clip_norm=args.grad_clip_norm,
        warmup_steps=args.warmup_steps,
        ema_decay=args.ema_decay,
        zero_opt=args.zero_opt,
        grad_accum=args.grad_accum,
    )
    Trainer(
        model_cfg, train_cfg,
        stream_dtype=torch.bfloat16 if args.stream_bf16 else None,
        device=args.device,
    ).fit(args.data_dir, resume=args.resume, device_resident=args.device_resident,
          checkpoint_format=args.ckpt_format, store_sharding=args.store_sharding)


if __name__ == "__main__":
    main()
