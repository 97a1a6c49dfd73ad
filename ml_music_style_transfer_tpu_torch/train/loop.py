"""Training loop: the port's ``Trainer`` (the JAX package's ``train/loop.py``).

Reference model/train.py:125-208, on one card:
  - ``train_step``: forward in training mode (DenseConcat dropout through
    the Philox kernel, seeded per step) + L1 (+ optional spectral loss) +
    backward + Adam(lr 1e-3, betas (0.9, 0.999), eps 1e-8, optax's
    defaults); it returns the loss as a device tensor, with no host sync;
  - ``eval_step``: MSE in eval mode, weight-masked so padded batches stay
    exact;
  - host batches are staged onto the card two ahead from pinned memory
    with non-blocking copies, optionally as bfloat16 (``stream_dtype``;
    the per-item ``weight`` stays float32);
  - ReduceLROnPlateau on the test loss, best-on-test-loss checkpoints
    (``checkpoint-{epoch}.pt``), the reference's hyperparams.json contract,
    a ``metrics.jsonl`` stream and resume from the newest checkpoint.

Unlike the JAX Trainer, which threads (params, opt_state) through pure
jitted steps, this one holds the model and optimizer and updates them in
place. ``init_state`` (or ``fit``) builds both; the other methods use them.
The device-resident data path, the JAX checkpoint formats and the
optimizer options of ``TrainConfig`` that ``unsupported_train_options``
lists raise ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Iterator

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig, unsupported_train_options
from ..data.dataset import ChunkDataset, process_data
from ..device import resolve_device
from ..models import PerformanceNet
from ..utils.logging import MetricsLogger
from . import checkpoint as ckpt
from . import losses
from .schedule import ReduceLROnPlateau

DEVICE_STORE_ITEM = "ROADMAP queue 1 item 6 (data path: device store)"


def device_prefetch(batches: Iterator[dict], device: torch.device, depth: int = 2,
                    stream_dtype: torch.dtype | None = None) -> Iterator[dict]:
    """Stage host (NumPy) batches onto ``device`` ``depth`` ahead.

    On the card each array is pinned and copied with ``non_blocking``, so
    the host assembles the next batch while the card works.
    ``stream_dtype=torch.bfloat16`` halves the bytes of midi/onoff/cond/
    target; ``weight`` stays float32.
    """
    def stage(b):
        out = {}
        for k, v in b.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if stream_dtype is not None and k != "weight":
                t = t.to(stream_dtype)
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return out

    buf = collections.deque()
    for b in batches:
        buf.append(stage(b))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class Trainer:
    """Experiment manager (reference main(), train.py:173-208)."""

    def __init__(self, model_cfg: ModelConfig = ModelConfig(),
                 train_cfg: TrainConfig = TrainConfig(), exp_root: str = "./experiments",
                 stream_dtype: torch.dtype | None = None, device="cuda"):
        bad = unsupported_train_options(train_cfg)
        if bad:
            raise NotImplementedError("; ".join(bad))
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.stream_dtype = stream_dtype
        self.scheduler = ReduceLROnPlateau(lr=train_cfg.learning_rate,
                                           factor=train_cfg.plateau_factor,
                                           patience=train_cfg.plateau_patience)
        self.exp_root = exp_root
        self.exp_dir = os.path.join(exp_root, train_cfg.exp_name)
        self.model: PerformanceNet | None = None
        self.optimizer: torch.optim.Adam | None = None
        # one 64-bit dropout seed per train step, drawn on the host
        self.dropout_gen = torch.Generator().manual_seed(train_cfg.seed)

    # ---- state --------------------------------------------------------
    def init_state(self, seed: int = 0):
        """Build the model (xavier-normal from a generator seeded ``seed``)
        and its Adam optimizer on the device. Other weights load in place
        afterwards (``model.load_state_dict``); the optimizer keeps them."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = PerformanceNet(self.model_cfg, device=self.device, generator=gen)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.scheduler.lr, betas=(0.9, 0.999), eps=1e-8,
            fused=True if self.device.type == "cuda" else None)
        return self.model, self.optimizer

    def state_dict(self, epoch: int) -> dict:
        """The checkpoint state, under the JAX package's keys."""
        return {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                "epoch": epoch, "scheduler": self.scheduler.state_dict()}

    def load_state(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.scheduler.load_state_dict(state["scheduler"])

    def set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def next_dropout_seed(self) -> int:
        lo, hi = torch.randint(0, 2**32, (2,), generator=self.dropout_gen).tolist()
        return lo | (hi << 32)

    # ---- steps --------------------------------------------------------
    def loss(self, batch: dict, dropout_seed: int) -> torch.Tensor:
        pred = self.model(batch["midi"], batch["cond"], batch["onoff"],
                          deterministic=False, dropout_seed=dropout_seed)
        loss = losses.l1_loss(pred, batch["target"], batch["weight"])
        if self.cfg.spectral_loss_weight > 0.0:
            loss = loss + self.cfg.spectral_loss_weight * losses.multiscale_spectral_loss(
                pred, batch["target"], batch["weight"], mode=self.cfg.spectral_loss_mode)
        return loss

    def train_step(self, batch: dict, dropout_seed: int) -> torch.Tensor:
        """One Adam step on ``batch`` (device tensors); returns the loss as
        a device scalar."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, dropout_seed)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch: dict) -> torch.Tensor:
        pred = self.model(batch["midi"], batch["cond"], batch["onoff"], deterministic=True)
        return losses.mse_loss(pred, batch["target"], batch["weight"])

    def train_step_resident(self, *args, **kwargs):
        """The JAX Trainer's device-resident variants (batch gather on the
        device) are not ported yet."""
        raise NotImplementedError(f"device-resident steps wait for {DEVICE_STORE_ITEM}")

    eval_step_resident = train_epoch_resident = evaluate_resident = train_step_resident

    # ---- epochs -------------------------------------------------------
    def train_epoch(self, dataset: ChunkDataset, epoch: int, log_every: int = 50,
                    exp=None) -> float:
        """One epoch (reference train(), train.py:125-149); the host reads a
        loss back only every ``log_every`` steps and once at the end."""
        losses_dev = []
        n_batches = dataset.batches_per_epoch(self.cfg.batch_size)
        batches = device_prefetch(
            dataset.epoch_batches(self.cfg.batch_size, shuffle=True, drop_last=True),
            self.device, stream_dtype=self.stream_dtype)
        t0 = time.time()
        for i, batch in enumerate(batches):
            loss = self.train_step(batch, self.next_dropout_seed())
            losses_dev.append(loss)
            if i % log_every == 0:  # float(loss) waits for the step
                print(f"Train Epoch: {epoch} [{i * self.cfg.batch_size}/{dataset.n_data} "
                      f"({100.0 * i / max(1, n_batches):.0f}%)]\tLoss: {float(loss):.6f}")
        epoch_losses = torch.stack(losses_dev).tolist() if losses_dev else []
        if exp is not None:
            exp.iter_train_loss.extend(epoch_losses)
        avg = float(np.mean(epoch_losses)) if epoch_losses else 0.0
        dt = time.time() - t0
        print(f"====> Epoch: {epoch} Average loss: {avg:.4f} "
              f"({len(epoch_losses) * self.cfg.batch_size / max(dt, 1e-9):.1f} chunks/s)")
        return avg

    def evaluate(self, dataset: ChunkDataset, exp=None) -> float:
        """Weighted-exact MSE over the whole split (reference test(),
        train.py:152-170); the last batch is padded and masked."""
        losses_dev, weights = [], []
        for batch in device_prefetch(
                dataset.epoch_batches(self.cfg.batch_size, shuffle=False, drop_last=False),
                self.device, stream_dtype=self.stream_dtype):
            losses_dev.append(self.eval_step(batch))
            weights.append(batch["weight"].sum())
        if not losses_dev:
            raise ValueError("the evaluation split is empty")
        batch_losses = torch.stack(losses_dev).tolist()
        w = torch.stack(weights).tolist()
        if exp is not None:
            exp.iter_test_loss.extend(batch_losses)
        test_loss = sum(l * wi for l, wi in zip(batch_losses, w)) / max(sum(w), 1.0)
        print(f"====> Test set loss: {test_loss:.4f}")
        return test_loss

    # ---- full fit (reference main(), train.py:173-208) ----------------
    def fit(self, data_dir: str, resume: bool = False, device_resident: bool = False,
            checkpoint_format: str = "torch"):
        """Train on ``{data_dir}_train.hdf5``, evaluate on ``_test.hdf5``
        every ``test_freq`` epochs and keep the best checkpoint. Returns
        (model, ExperimentState)."""
        if device_resident:
            raise NotImplementedError(f"device_resident=True waits for {DEVICE_STORE_ITEM}")
        if checkpoint_format != "torch":
            raise NotImplementedError(
                f"checkpoint_format={checkpoint_format!r}: the port writes its own .pt "
                f"checkpoints ('torch'); the JAX formats wait for {ckpt.JAX_FORMATS_ITEM}")
        os.makedirs(self.exp_root, exist_ok=True)
        if not resume:
            os.makedirs(self.exp_dir)  # same error-on-exists semantics (train.py:183)
        train_ds, test_ds = process_data(data_dir, self.cfg.n_train_read,
                                         self.cfg.n_test_read, self.cfg.seed)
        # the reference's DataLoader (drop_last=False) still trains on a set
        # smaller than one batch; whole batches only would run zero steps
        if train_ds.n_data < self.cfg.batch_size:
            if train_ds.n_data == 0:
                raise ValueError("the training split holds no chunks")
            print(f"batch_size {self.cfg.batch_size} exceeds the {train_ds.n_data}-chunk "
                  f"training set; clamping to {train_ds.n_data} (reference drop_last=False "
                  "semantics would otherwise train zero steps per epoch)")
            self.cfg = dataclasses.replace(self.cfg, batch_size=train_ds.n_data)
        self.init_state(self.cfg.seed)
        exp = ckpt.ExperimentState(self.cfg.epochs, self.cfg.test_freq, self.cfg.exp_name)
        start_epoch = 0
        if resume:
            latest = ckpt.latest_checkpoint(self.exp_dir)
            if latest is not None:
                path = latest[0]
                state = ckpt.restore_checkpoint(path, self.device)
                self.load_state(state)
                exp = ckpt.ExperimentState.load(self.exp_dir)
                start_epoch = state["epoch"]
                print(f"resumed from {path} at epoch {start_epoch}")

        self.dropout_gen = torch.Generator().manual_seed(self.cfg.seed)
        metrics = MetricsLogger(os.path.join(self.exp_dir, "metrics.jsonl"))
        print("start training")
        for epoch in range(start_epoch, self.cfg.epochs):
            t_epoch = time.time()
            avg = self.train_epoch(train_ds, epoch, exp=exp)
            n_batches = train_ds.batches_per_epoch(self.cfg.batch_size)
            exp.loss_history.append(avg)
            dt = time.time() - t_epoch
            metrics.log("train_epoch", epoch=epoch, loss=avg, lr=self.scheduler.lr,
                        epoch_sec=dt, device_resident=False,
                        frames_per_sec=n_batches * self.cfg.batch_size * 860 / max(dt, 1e-9))
            if epoch % self.cfg.test_freq == 0:
                test_loss = self.evaluate(test_ds, exp=exp)
                exp.test_loss_history.append(test_loss)
                self.set_lr(self.scheduler.step(test_loss))
                metrics.log("eval", epoch=epoch, test_loss=test_loss, lr=self.scheduler.lr)
                if test_loss < exp.best_loss:
                    print("saving model")
                    ckpt.save_checkpoint(self.exp_dir, epoch + 1, self.state_dict(epoch + 1))
                    exp.best_loss = test_loss
                    exp.best_epoch = epoch + 1
                    exp.save(self.exp_dir)
                    metrics.log("checkpoint", epoch=epoch + 1, best_loss=test_loss)
        metrics.close()
        return self.model, exp
