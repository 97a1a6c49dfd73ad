"""Training CLI: the reference's train.py entry point, the JAX package's
flags, plus ``--device`` (default ``cuda``; with no card it fails).

    python -m ml_music_style_transfer_tpu_torch.train.cli \
        -data-dir PATH_BASENAME -exp-name NAME [-epochs N] [-test-freq N] \
        [--batch-size N] [--n-train-read N] [--n-test-read N] [--resume] \
        [--width-mult F] [--spectral-loss W] [--stream-bf16] [--device-resident] \
        [--adam-mu-dtype bfloat16] [--adam-nu-dtype bfloat16] [--grads-dtype bfloat16] \
        [--grad-clip-norm X] [--warmup-steps N] [--ema-decay D] [--grad-accum K] \
        [--ckpt-format torch|msgpack|dcp|orbax] [--device D] \
        [--mesh-data N] [--mesh-model M] [--zero-opt] [--store-sharding replicated|data]

Reading the HDF5 dataset needs ``h5py``. ``--device-resident`` keeps the
train split on the card (a file preprocessed with ``--store-audio``) and
assembles each batch there. The optimizer options are the JAX package's
(``train/optim.py``); ``--ckpt-format msgpack`` writes the JAX package's
``checkpoint-{epoch}.msgpack``, which its ``restore_checkpoint`` reads, and
``--ckpt-format dcp`` a sharded ``checkpoint-{epoch}.dcp`` directory
(``torch.distributed.checkpoint``), written in the background while
training goes on, each rank of a mesh its own slices. ``--resume`` reads
any of these and the JAX package's orbax directories.
``--debug-nans`` trains under ``utils/profiling.nan_debugging``: the first
operator that outputs a NaN raises ``FloatingPointError`` naming it (the
JAX package's ``jax_debug_nans``). Every CUDA kernel is built before the
first step (``enable_persistent_compile_cache``).

A mesh trains over several cards, one rank per card under torchrun; the
mesh's rank count (data x model) must equal the launch's:

    torchrun --nproc-per-node 4 -m ml_music_style_transfer_tpu_torch.train.cli \
        -data-dir PATH -exp-name NAME --mesh-data 2 --mesh-model 2 --zero-opt

``--mesh-data`` shards each batch (DP), ``--mesh-model`` the wide channel
dims (TP), ``--zero-opt`` the optimizer state over the data axis (ZeRO-1),
and ``--store-sharding data`` splits a ``--device-resident`` store's rows
over the data axis. ``--device cpu`` runs the ranks on the CPU (gloo).
``--ckpt-format orbax`` writes the JAX package's orbax directories
(``checkpoint-{epoch}.orbax``) in the background; it and ``dcp`` write
each rank's own slices on a mesh, with nothing gathered. Reference CLI:
model/train.py:211-220.
"""
from __future__ import annotations

import argparse
import contextlib

import torch

from ..config import ModelConfig, TrainConfig
from ..utils.profiling import enable_persistent_compile_cache, nan_debugging
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
                   help="fail fast on the first operator that outputs a NaN (slow: a "
                        "device sync per operator)")
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
                   help="device-resident store placement on a mesh: whole on every rank, "
                        "or its rows split over the data axis")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--zero-opt", action="store_true",
                   help="shard the optimizer state over the data axis (ZeRO-1)")
    p.add_argument("--ckpt-format", choices=("torch", "msgpack", "dcp", "orbax"),
                   default="torch",
                   help="'torch': checkpoint-{epoch}.pt via torch.save (the port's "
                        "format); 'msgpack': the JAX package's flax msgpack; 'dcp': "
                        "sharded asynchronous checkpoint-{epoch}.dcp directories; "
                        "'orbax': the JAX package's checkpoint-{epoch}.orbax "
                        "directories, written in the background")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    enable_persistent_compile_cache(args.device)  # no step pays for nvcc
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
    trainer = Trainer(
        model_cfg, train_cfg,
        stream_dtype=torch.bfloat16 if args.stream_bf16 else None,
        device=args.device,
    )
    with nan_debugging() if args.debug_nans else contextlib.nullcontext():
        trainer.fit(args.data_dir, resume=args.resume, device_resident=args.device_resident,
                    checkpoint_format=args.ckpt_format, store_sharding=args.store_sharding)


if __name__ == "__main__":
    main()
