"""Training loop: the port's ``Trainer`` (the JAX package's ``train/loop.py``).

Reference model/train.py:125-208, on one card:
  - ``train_step``: forward in training mode (DenseConcat dropout through
    the Philox kernel, seeded per step) + L1 (+ optional spectral loss) +
    backward + Adam(lr 1e-3, betas (0.9, 0.999), eps 1e-8, optax's
    defaults); it returns the loss as a device tensor, with no host sync;
  - ``eval_step``: MSE in eval mode, weight-masked so padded batches stay
    exact;
  - host batches come from the native slot-ring assembler
    (``use_native_loader=True``, the default: the JAX Trainer's
    ``_train_batches``; its slots are page-locked on the card, and a slot
    is released only after an event on its copy has completed) or from
    Python assembly, and are staged onto the card with non-blocking
    copies, optionally as bfloat16 (``stream_dtype``; the per-item
    ``weight`` stays float32);
  - the device-resident path (``DeviceDataStore``): the split lives on the
    card, and each step gathers its batch and computes its spectrograms
    there (``train_step_resident``, ``eval_step_resident``,
    ``train_epoch_resident``, ``evaluate_resident``,
    ``fit(device_resident=True)``); only index vectors cross per step;
  - ReduceLROnPlateau on the test loss, best-on-test-loss checkpoints
    (``checkpoint-{epoch}.pt``), the reference's hyperparams.json contract,
    a ``metrics.jsonl`` stream and resume from the newest checkpoint.

Unlike the JAX Trainer, which threads (params, opt_state) through pure
jitted steps, this one holds the model and optimizer and updates them in
place. ``init_state`` (or ``fit``) builds both; the other methods use them.
The JAX checkpoint formats, a store on a mesh and the optimizer options
of ``TrainConfig`` that ``unsupported_train_options`` lists raise
``NotImplementedError``.
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
from ..data.device_store import DeviceDataStore, check_placement, gather_batch
from ..device import resolve_device
from ..models import PerformanceNet
from ..utils.logging import MetricsLogger
from . import checkpoint as ckpt
from . import losses
from .schedule import ReduceLROnPlateau


def stage_batch(b: dict, device: torch.device,
                stream_dtype: torch.dtype | None = None) -> dict:
    """One host (NumPy) batch on ``device``. To the card each array goes
    from pinned memory (already page-locked memory as it is, else a pinned
    copy) with a non-blocking copy. ``stream_dtype=torch.bfloat16`` halves
    the bytes of midi/onoff/cond/target; ``weight`` stays float32."""
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if stream_dtype is not None and k != "weight":
            t = t.to(stream_dtype)
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def device_prefetch(batches: Iterator[dict], device: torch.device, depth: int = 2,
                    stream_dtype: torch.dtype | None = None) -> Iterator[dict]:
    """Stage host batches onto ``device`` ``depth`` ahead (``stage_batch``),
    so the host assembles the next batch while the card works."""
    buf = collections.deque()
    for b in batches:
        buf.append(stage_batch(b, device, stream_dtype))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class Trainer:
    """Experiment manager (reference main(), train.py:173-208)."""

    def __init__(self, model_cfg: ModelConfig = ModelConfig(),
                 train_cfg: TrainConfig = TrainConfig(), exp_root: str = "./experiments",
                 stream_dtype: torch.dtype | None = None, device="cuda",
                 use_native_loader: bool = True):
        bad = unsupported_train_options(train_cfg)
        if bad:
            raise NotImplementedError("; ".join(bad))
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.stream_dtype = stream_dtype
        self.use_native_loader = use_native_loader
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

    def train_step_resident(self, audio, roll, onoff, idx, cond_idx, style,
                            dropout_seed: int) -> torch.Tensor:
        """``train_step`` on a batch gathered and STFT'd on the device from
        a ``DeviceDataStore``'s tensors at the index vectors."""
        return self.train_step(gather_batch(audio, roll, onoff, idx, cond_idx, style),
                               dropout_seed)

    @torch.no_grad()
    def eval_step_resident(self, audio, roll, onoff, idx, cond_idx, style,
                           weight=None) -> torch.Tensor:
        return self.eval_step(gather_batch(audio, roll, onoff, idx, cond_idx, style,
                                           weight=weight))

    # ---- epochs -------------------------------------------------------
    def _train_batches(self, dataset: ChunkDataset) -> Iterator[dict]:
        """One epoch of train batches on the device: from the native
        assembler (its own draw order) or from Python assembly."""
        bs = self.cfg.batch_size
        if not self.use_native_loader:
            yield from device_prefetch(dataset.epoch_batches(bs, shuffle=True, drop_last=True),
                                       self.device, stream_dtype=self.stream_dtype)
            return
        on_card = self.device.type == "cuda"
        asm = dataset.native_assembler(bs, pin_memory=on_card)
        for batch in asm.epoch_batches(shuffle=True):
            dev = stage_batch(batch, self.device, self.stream_dtype)
            if on_card:
                copied = torch.cuda.Event()
                copied.record()
            try:
                yield dev
            finally:
                if on_card:
                    # the slot recycles when the loop resumes (or closes):
                    # its copy must have run. It queued behind the previous
                    # step, so the host stays one step ahead.
                    copied.synchronize()

    def _epoch_report(self, epoch: int, losses_dev: list, t0: float, exp, note: str = "") -> float:
        epoch_losses = torch.stack(losses_dev).tolist() if losses_dev else []
        if exp is not None:
            exp.iter_train_loss.extend(epoch_losses)
        avg = float(np.mean(epoch_losses)) if epoch_losses else 0.0
        dt = time.time() - t0
        print(f"====> Epoch: {epoch} Average loss: {avg:.4f} "
              f"({len(epoch_losses) * self.cfg.batch_size / max(dt, 1e-9):.1f} chunks/s{note})")
        return avg

    def train_epoch(self, dataset: ChunkDataset, epoch: int, log_every: int = 50,
                    exp=None) -> float:
        """One epoch (reference train(), train.py:125-149); the host reads a
        loss back only every ``log_every`` steps and once at the end."""
        losses_dev = []
        n_batches = dataset.batches_per_epoch(self.cfg.batch_size)
        batches = self._train_batches(dataset)
        t0 = time.time()
        for i, batch in enumerate(batches):
            loss = self.train_step(batch, self.next_dropout_seed())
            losses_dev.append(loss)
            if i % log_every == 0:  # float(loss) waits for the step
                print(f"Train Epoch: {epoch} [{i * self.cfg.batch_size}/{dataset.n_data} "
                      f"({100.0 * i / max(1, n_batches):.0f}%)]\tLoss: {float(loss):.6f}")
        return self._epoch_report(epoch, losses_dev, t0, exp)

    def train_epoch_resident(self, store: DeviceDataStore, epoch: int, exp=None) -> float:
        """One epoch against a ``DeviceDataStore``: per step three index
        vectors go to the card; the loss is read back once, at the end."""
        losses_dev = []
        t0 = time.time()
        for idx, cond_idx, style in store.draw_epoch_indices(self.cfg.batch_size):
            losses_dev.append(self.train_step_resident(
                store.audio, store.pianoroll, store.onoff, idx, cond_idx, style,
                self.next_dropout_seed()))
        return self._epoch_report(epoch, losses_dev, t0, exp, ", device-resident")

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

    def evaluate_resident(self, store: DeviceDataStore, exp=None) -> float:
        """Weighted-exact MSE over a device-resident split (reference
        test(), train.py:152-170), with the store's deterministic plan."""
        losses_dev, weights = [], []
        for idx, cond_idx, style, weight in store.eval_epoch_indices(self.cfg.batch_size):
            losses_dev.append(self.eval_step_resident(
                store.audio, store.pianoroll, store.onoff, idx, cond_idx, style, weight))
            weights.append(weight.sum())
        if not losses_dev:
            raise ValueError("the evaluation split is empty")
        batch_losses = torch.stack(losses_dev).tolist()
        w = torch.stack(weights).tolist()
        if exp is not None:
            exp.iter_test_loss.extend(batch_losses)
        test_loss = sum(l * wi for l, wi in zip(batch_losses, w)) / max(sum(w), 1.0)
        print(f"====> Test set loss: {test_loss:.4f} (device-resident)")
        return test_loss

    # ---- full fit (reference main(), train.py:173-208) ----------------
    def fit(self, data_dir: str, resume: bool = False, device_resident: bool = False,
            device_audio_dtype: torch.dtype | None = None, checkpoint_format: str = "torch",
            store_sharding: str = "replicated"):
        """Train on ``{data_dir}_train.hdf5``, evaluate on ``_test.hdf5``
        every ``test_freq`` epochs and keep the best checkpoint. Returns
        (model, ExperimentState).

        ``device_resident=True`` keeps the train split on the device
        (``DeviceDataStore``; the file needs ``--store-audio``) with its
        audio as ``device_audio_dtype`` (bfloat16 by default, whose targets
        differ from the host path's; ``torch.float32`` for parity). A test
        split without ``audio_*`` keys is evaluated from host batches, with
        a notice. ``store_sharding="data"`` raises (one card).
        """
        check_placement(None, store_sharding)
        if checkpoint_format != "torch":
            raise NotImplementedError(
                f"checkpoint_format={checkpoint_format!r}: the port writes its own .pt "
                f"checkpoints ('torch'); the JAX formats wait for {ckpt.JAX_FORMATS_ITEM}")
        os.makedirs(self.exp_root, exist_ok=True)
        if not resume:
            os.makedirs(self.exp_dir)  # same error-on-exists semantics (train.py:183)
        store = test_store = train_ds = test_ds = None
        if device_resident:
            store_kw = {"store_sharding": store_sharding, "device": self.device}
            if device_audio_dtype is not None:
                store_kw["audio_dtype"] = device_audio_dtype
            store = DeviceDataStore(data_dir + "_train.hdf5", n_read=self.cfg.n_train_read,
                                    seed=self.cfg.seed, **store_kw)
            print(f"device-resident dataset: {store.n_data} chunks x {len(store.styles)} "
                  f"styles, {store.hbm_bytes() / 1e9:.2f} GB on {self.device}")
            try:
                test_store = DeviceDataStore(data_dir + "_test.hdf5",
                                             n_read=self.cfg.n_test_read,
                                             seed=self.cfg.seed + 1, **store_kw)
            except (ValueError, OSError) as e:
                if "misaligned" in str(e):
                    raise  # a corrupt split, not one without audio
                # a test split preprocessed without --store-audio: evaluate
                # from host batches, and say so
                print(f"device-resident test split unavailable ({e}); "
                      "evaluating via the host-streamed path")
                test_ds = ChunkDataset(data_dir + "_test.hdf5", n_read=self.cfg.n_test_read,
                                       seed=self.cfg.seed + 1)
        else:
            train_ds, test_ds = process_data(data_dir, self.cfg.n_train_read,
                                             self.cfg.n_test_read, self.cfg.seed)
        # the reference's DataLoader (drop_last=False) still trains on a set
        # smaller than one batch; whole batches only would run zero steps
        n_train = store.n_data if store is not None else train_ds.n_data
        if n_train < self.cfg.batch_size:
            if n_train == 0:
                raise ValueError("the training split holds no chunks")
            print(f"batch_size {self.cfg.batch_size} exceeds the {n_train}-chunk "
                  f"training set; clamping to {n_train} (reference drop_last=False "
                  "semantics would otherwise train zero steps per epoch)")
            self.cfg = dataclasses.replace(self.cfg, batch_size=n_train)
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
            if store is not None:
                avg = self.train_epoch_resident(store, epoch, exp=exp)
                n_batches = store.n_data // self.cfg.batch_size
            else:
                avg = self.train_epoch(train_ds, epoch, exp=exp)
                n_batches = train_ds.batches_per_epoch(self.cfg.batch_size)
            exp.loss_history.append(avg)
            dt = time.time() - t_epoch
            metrics.log("train_epoch", epoch=epoch, loss=avg, lr=self.scheduler.lr,
                        epoch_sec=dt, device_resident=store is not None,
                        frames_per_sec=n_batches * self.cfg.batch_size * 860 / max(dt, 1e-9))
            if epoch % self.cfg.test_freq == 0:
                if test_store is not None:
                    test_loss = self.evaluate_resident(test_store, exp=exp)
                else:
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
