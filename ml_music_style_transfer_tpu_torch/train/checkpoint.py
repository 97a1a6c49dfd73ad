"""Checkpoint save/restore and the reference's hyperparams.json contract.

Counterpart of the JAX package's ``train/checkpoint.py`` (:27-70, :180-220).
The reference saves ``{'epoch', 'state_dict', 'optimizer'}`` tar files on a
test-loss improvement, and a hyperparams.json whose ``best_epoch`` names the
checkpoint inference loads (model/train.py:202-208, inference.py:120-122).
This module keeps that contract (``ExperimentState`` writes the same field
names) and the JAX package's resume path.

Two file formats:
  - ``checkpoint-{epoch}.pt`` (``torch.save``, the port's default) holds the
    JAX state's keys with the port's values: ``{"params": model
    state_dict (reference key names), "opt_state": ``optim.export_state``
    (the optimizer's state keyed by parameter name), "epoch",
    "scheduler"}``, plus ``"ema_params"`` where the
    run kept an EMA;
  - ``checkpoint-{epoch}.msgpack`` is the JAX package's flax msgpack,
    read and written by ``train/flax_msgpack.py`` (no flax, no msgpack):
    its trees are in the JAX layout (``compat/weights.py`` translates).
    ``restore_checkpoint`` returns such a file's tree as it stands; the
    ``Trainer`` and the synthesizer translate it.
Where both formats hold one epoch, the ``.pt`` wins. Orbax directories
(``checkpoint-{epoch}.orbax``) need orbax, which the card's machine lacks:
a directory holding only those raises ``NotImplementedError`` naming
ROADMAP queue 1 item 7a.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Iterable

import torch

from . import flax_msgpack

ORBAX_ITEM = "ROADMAP queue 1 item 7a (orbax checkpoints)"
FORMATS = {"torch": "pt", "msgpack": "msgpack"}


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


def checkpoint_path(exp_dir: str, epoch: int, fmt: str = "torch") -> str:
    return os.path.join(exp_dir, f"checkpoint-{epoch}.{FORMATS[fmt]}")


def save_checkpoint(exp_dir: str, epoch: int, state: dict, fmt: str = "torch") -> str:
    """Write ``state`` as checkpoint-{epoch}.pt (``fmt="torch"``) or as
    flax msgpack, checkpoint-{epoch}.msgpack (``fmt="msgpack"``; ``state``
    in the JAX layout, e.g. ``Trainer.jax_state_dict``), via a temporary
    file, so a crash mid-write never leaves a truncated checkpoint under
    its name."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown checkpoint format {fmt!r}; 'torch' or 'msgpack' "
                         f"('orbax' waits for {ORBAX_ITEM})")
    path = checkpoint_path(exp_dir, epoch, fmt)
    if fmt == "msgpack":
        return flax_msgpack.dump(state, path)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, device="cpu", keys: Iterable[str] | None = None
                       ) -> dict[str, Any]:
    """The dict a checkpoint holds: a ``.pt`` with its tensors on
    ``device``; a ``.msgpack`` as its flax tree of CPU tensors (only the
    top-level ``keys`` where given, the rest skipped unread)."""
    if path.endswith(".msgpack"):
        return flax_msgpack.load(path, keys)
    if path.endswith(".orbax"):
        raise NotImplementedError(f"{path}: reading orbax checkpoints waits for {ORBAX_ITEM}")
    state = torch.load(path, map_location=device, weights_only=True)
    return state if keys is None else {k: state[k] for k in keys if k in state}


def _epochs(exp_dir: str, ext: str) -> dict[int, str]:
    out = {}
    for p in glob.glob(os.path.join(exp_dir, f"checkpoint-*.{ext}")):
        m = re.search(rf"checkpoint-(\d+)\.{ext}$", p)
        if m:
            out[int(m.group(1))] = p
    return out


def latest_checkpoint(exp_dir: str) -> tuple[str, int] | None:
    """(path, epoch) of the newest .pt or .msgpack checkpoint in exp_dir
    (the .pt where both hold that epoch), or None. Raises
    NotImplementedError where only orbax checkpoints exist."""
    found = {**_epochs(exp_dir, "msgpack"), **_epochs(exp_dir, "pt")}
    if found:
        epoch = max(found)
        return found[epoch], epoch
    orbax = _epochs(exp_dir, "orbax")
    if orbax:
        raise NotImplementedError(
            f"{exp_dir} holds only orbax checkpoints ({os.path.basename(orbax[max(orbax)])}, "
            f"...); reading them waits for {ORBAX_ITEM}")
    return None


def best_checkpoint(exp_dir: str) -> tuple[str, int]:
    """The checkpoint inference should load, via hyperparams.json's
    best_epoch: ``checkpoint-{best}.pt``, else ``.msgpack``, else the
    reference's own ``checkpoint-{best}.tar`` (train.py:202-204), else the
    newest .pt or .msgpack (a best-epoch file lost in a crash; with a
    warning). Where only orbax checkpoints exist it raises
    NotImplementedError."""
    with open(os.path.join(exp_dir, "hyperparams.json")) as f:
        best = json.load(f)["best_epoch"]  # all inference reads (inference.py:120-122)
    for path in (checkpoint_path(exp_dir, best), checkpoint_path(exp_dir, best, "msgpack"),
                 os.path.join(exp_dir, f"checkpoint-{best}.tar")):
        if os.path.exists(path):
            return path, best
    latest = latest_checkpoint(exp_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint in {exp_dir} (best_epoch={best})")
    print(f"warning: best_epoch={best} checkpoint missing; using {latest[0]}")
    return latest
