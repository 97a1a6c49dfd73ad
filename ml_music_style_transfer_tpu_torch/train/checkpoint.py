"""Checkpoint save/restore and the reference's hyperparams.json contract.

Counterpart of the JAX package's ``train/checkpoint.py`` (:27-70, :180-220).
The reference saves ``{'epoch', 'state_dict', 'optimizer'}`` tar files on a
test-loss improvement, and a hyperparams.json whose ``best_epoch`` names the
checkpoint inference loads (model/train.py:202-208, inference.py:120-122).
This module keeps that contract (``ExperimentState`` writes the same field
names) and the JAX package's resume path.

The file format differs from the JAX package's on purpose. The JAX package
writes flax msgpack (``checkpoint-{epoch}.msgpack``) or orbax directories;
the machine that trains the port has neither flax nor msgpack nor orbax,
so the port writes ``checkpoint-{epoch}.pt`` with ``torch.save``, holding
the JAX state's keys: ``{"params": model state_dict (reference key names),
"opt_state": optimizer.state_dict(), "epoch", "scheduler"}``. Reading the
JAX package's msgpack/orbax checkpoints waits for ROADMAP queue 1 item 7;
a directory holding only those raises ``NotImplementedError``.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Any

import torch

JAX_FORMATS_ITEM = "ROADMAP queue 1 item 7 (reading the JAX package's msgpack/orbax checkpoints)"


class ExperimentState:
    """The reference's mutable hyperparams bag (train.py:32-42), JSON-compatible."""

    def __init__(self, train_epoch: int, test_freq: int, exp_name: str):
        self.train_epoch = train_epoch
        self.test_freq = test_freq
        self.exp_name = exp_name
        self.iter_train_loss: list[float] = []
        self.iter_test_loss: list[float] = []
        self.loss_history: list[float] = []
        self.test_loss_history: list[float] = []
        self.best_loss: float = 1e10
        self.best_epoch: int = 0

    def save(self, exp_dir: str) -> None:
        with open(os.path.join(exp_dir, "hyperparams.json"), "w") as f:
            json.dump(self.__dict__, f)

    @classmethod
    def load(cls, exp_dir: str) -> "ExperimentState":
        with open(os.path.join(exp_dir, "hyperparams.json")) as f:
            d = json.load(f)
        obj = cls(d["train_epoch"], d["test_freq"], d["exp_name"])
        obj.__dict__.update(d)
        return obj


def checkpoint_path(exp_dir: str, epoch: int) -> str:
    return os.path.join(exp_dir, f"checkpoint-{epoch}.pt")


def save_checkpoint(exp_dir: str, epoch: int, state: dict) -> str:
    """Write ``state`` as checkpoint-{epoch}.pt (via a temporary file, so a
    crash mid-write never leaves a truncated checkpoint under its name)."""
    path = checkpoint_path(exp_dir, epoch)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, device="cpu") -> dict[str, Any]:
    """The dict a ``save_checkpoint`` wrote, its tensors on ``device``."""
    if not path.endswith(".pt"):
        raise NotImplementedError(f"{path}: the port reads its own .pt checkpoints; "
                                  f"other formats wait for {JAX_FORMATS_ITEM}")
    return torch.load(path, map_location=device, weights_only=True)


def _epochs(exp_dir: str, ext: str) -> dict[int, str]:
    out = {}
    for p in glob.glob(os.path.join(exp_dir, f"checkpoint-*.{ext}")):
        m = re.search(rf"checkpoint-(\d+)\.{ext}$", p)
        if m:
            out[int(m.group(1))] = p
    return out


def _refuse_jax_formats(exp_dir: str) -> None:
    found = sorted(p for ext in ("msgpack", "orbax") for p in _epochs(exp_dir, ext).values())
    if found:
        raise NotImplementedError(
            f"{exp_dir} holds only JAX-package checkpoints ({os.path.basename(found[-1])}, ...); "
            f"the port reads .pt and reference .tar files, and these wait for {JAX_FORMATS_ITEM}")


def latest_checkpoint(exp_dir: str) -> tuple[str, int] | None:
    """(path, epoch) of the newest .pt checkpoint in exp_dir, or None.
    Raises NotImplementedError where only msgpack/orbax checkpoints exist."""
    pts = _epochs(exp_dir, "pt")
    if pts:
        epoch = max(pts)
        return pts[epoch], epoch
    _refuse_jax_formats(exp_dir)
    return None


def best_checkpoint(exp_dir: str) -> tuple[str, int]:
    """The checkpoint inference should load, via hyperparams.json's
    best_epoch: ``checkpoint-{best}.pt``, else the reference's own
    ``checkpoint-{best}.tar`` (train.py:202-204), else the newest .pt
    (a best-epoch file lost in a crash; with a warning). Where only
    msgpack/orbax checkpoints exist it raises NotImplementedError."""
    with open(os.path.join(exp_dir, "hyperparams.json")) as f:
        best = json.load(f)["best_epoch"]  # all inference reads (inference.py:120-122)
    for path in (checkpoint_path(exp_dir, best),
                 os.path.join(exp_dir, f"checkpoint-{best}.tar")):
        if os.path.exists(path):
            return path, best
    latest = latest_checkpoint(exp_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint in {exp_dir} (best_epoch={best})")
    print(f"warning: best_epoch={best} checkpoint missing; using {latest[0]}")
    return latest
