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
  - the optimizer options of ``TrainConfig`` (moment and gradient dtypes,
    clipping, warmup, parameter EMA, gradient accumulation) through
    ``train/optim.py``, on host-fed and resident steps alike; with none set
    the optimizer is ``torch.optim.Adam`` (fused on the card);
  - ReduceLROnPlateau on the test loss, best-on-test-loss checkpoints
    (``checkpoint-{epoch}.pt``, the JAX package's flax msgpack with
    ``checkpoint_format="msgpack"``, a sharded asynchronous
    ``checkpoint-{epoch}.dcp`` with ``"dcp"``, or the JAX package's orbax
    directory, written in the background, with ``"orbax"``), the reference's
    hyperparams.json contract, a ``metrics.jsonl`` stream and resume from
    the newest checkpoint of any format. With ``ema_decay`` set, ``fit``
    evaluates the EMA weights, ranks epochs by them and checkpoints them as
    ``ema_params`` beside ``params``.

Unlike the JAX Trainer, which threads (params, opt_state) through pure
jitted steps, this one holds the model and optimizer and updates them in
place. ``init_state`` (or ``fit``) builds both; the other methods use them.

On a mesh (``mesh=``, or ``TrainConfig.mesh_shape`` other than (1, 1),
built over the launch's ranks by ``parallel/mesh.make_mesh``) each rank
runs this Trainer on its share of every global batch (``shard_batch``:
the batch axes ``data``, or ``dcn`` x ``data``):
  - DP: the loss is the global batch's weighted mean; each rank
    back-propagates its share of it and the gradients are summed over the
    batch axes (an explicit all-reduce per parameter, so it composes with
    ``grad_accum``'s microbatches);
  - TP (``model`` axis): the model is sharded Megatron-style
    (``PerformanceNet.shard_tensor_parallel_``);
  - ZeRO-1 (``zero_opt``): ``optim.ZeroOptimizer`` keeps each rank's
    slices of the optimizer state; with no mesh ``zero_opt`` changes
    nothing (one device, as the JAX Trainer's 1-wide data axis);
  - dropout: data rank d draws with ``dropout.fold_seed(seed, d)``, so the
    masks differ across data ranks while rank 0 draws one device's masks;
  - ``.pt`` and ``.msgpack`` checkpoints hold whole tensors: saving
    gathers the TP slices and the ZeRO slices of the optimizer state
    (every rank takes part, rank 0 writes), and a resume gives each rank
    its slices again. A ``.dcp`` or an ``.orbax`` gathers nothing: each
    rank writes the slices it holds (``sharded_state_dict``;
    ``orbax_state``, the same slices in the JAX layout) and a resume
    reads only them (``load_sharded_state``, ``load_orbax_sharded``);
  - the device-resident store is replicated or sharded over the data axis
    (``store_sharding``; ``DeviceDataStore.local_batch``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import time
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..compat import weights
from ..config import ModelConfig, TrainConfig
from ..data.dataset import ChunkDataset, process_data
from ..data.device_store import DeviceDataStore, check_placement, gather_batch
from ..device import resolve_device
from ..models import PerformanceNet
from ..ops.kernels.dropout import fold_seed
from ..parallel import comm
from ..parallel import mesh as pmesh
from ..utils import profiling
from ..utils.logging import MetricsLogger
from . import checkpoint as ckpt
from . import losses, optim, orbax_format
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


def rank_orbax_state(state: dict, cfg: TrainConfig, shape: dict[str, int], rank: int) -> dict:
    """``Trainer.orbax_state`` of rank ``rank`` of a ``make_mesh`` mesh of
    ``shape`` (e.g. ``{"data": 2, "model": 2}``) with ``cfg``'s ZeRO
    option, cut from the whole state ``state`` (``Trainer.state_dict``'s,
    tensors on any device) with no process group: each tensor's block is
    a view of it at the place the placements of a ``Trainer`` on that mesh
    give (``parallel/mesh.tp_dims``, ``zero_extend``). One process can so
    write the directory of every rank (``orbax_format.write_shards``)."""
    names, ranks = pmesh.checkpoint_ranks(shape)
    n_batch = math.prod(n for a, n in shape.items() if a != "model")
    tp = pmesh.tp_dims({k: tuple(v.shape) for k, v in state["params"].items()},
                       shape.get("model", 1))

    def local(key, t):
        size = list(t.shape)
        if key in tp:
            size[tp[key]] //= shape["model"]
        return size

    def cut(tensors: dict, sliced: bool) -> dict:
        out = {}
        for k, t in tensors.items():
            zero = (pmesh.zero_extend(local(k, t), n_batch)
                    if sliced and cfg.zero_opt else None)
            offset, size, write = pmesh.shard_box(
                ranks, rank, pmesh.placements(names, tp.get(k), zero), tuple(t.shape))
            block = t[tuple(slice(o, o + n) for o, n in zip(offset, size))]
            out[k] = orbax_format.Shard(block, tuple(t.shape), offset, size, t.dtype, write)
        return out

    blocks = {"params": cut(state["params"], False),
              "opt_state": {k: cut(v, True) if k in ("mu", "nu", "ema", "acc")
                            and v is not None else v for k, v in state["opt_state"].items()},
              "epoch": state["epoch"], "scheduler": state["scheduler"]}
    if "ema_params" in state:
        blocks["ema_params"] = cut(state["ema_params"], True)
    return weights.to_jax_state(blocks, cfg, leaf=lambda b, dims: b.permute(dims))


class Trainer:
    """Experiment manager (reference main(), train.py:173-208)."""

    def __init__(self, model_cfg: ModelConfig = ModelConfig(),
                 train_cfg: TrainConfig = TrainConfig(), exp_root: str = "./experiments",
                 stream_dtype: torch.dtype | None = None, device="cuda",
                 use_native_loader: bool = True, mesh=None):
        """``mesh``: a ``parallel/mesh.make_mesh`` mesh; None builds one of
        ``train_cfg.mesh_shape`` over the launch's ranks on ``device``'s
        kind when that is not (1, 1), else trains on one device."""
        with profiling.setup_span("setup.model"):
            if mesh is None and tuple(train_cfg.mesh_shape) != (1, 1):
                mesh = pmesh.make_mesh(*train_cfg.mesh_shape, device=device)
            self.mesh = mesh
            if mesh is None:
                self.device = resolve_device(device)
            else:
                if torch.device(device).type != mesh.device_type:
                    raise ValueError(f"device {device!r} on a {mesh.device_type} mesh")
                self.device = pmesh.mesh_device(mesh)
            self._batch_group = pmesh.batch_group(mesh)
            self._model_group = pmesh.axis_group(mesh, "model")
            self.n_batch_shards = pmesh.batch_size(mesh)
            self.batch_rank = pmesh.batch_rank(mesh)
            self.is_main = mesh is None or dist.get_rank() == 0
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
            self.optimizer: torch.optim.Adam | optim.TrainOptimizer | None = None
            # one 64-bit dropout seed per train step, drawn on the host
            self.dropout_gen = torch.Generator().manual_seed(train_cfg.seed)

    # ---- state --------------------------------------------------------
    def init_state(self, seed: int = 0):
        """Build the model (xavier-normal from a generator seeded ``seed``)
        and its optimizer on the device (``optim.build_optimizer``: fused
        Adam, or the chain of the config's options). Other weights load in
        place afterwards (``model.load_state_dict``); the optimizer keeps
        them, and an EMA starts from the weights it was built on."""
        with profiling.setup_span("setup.model"):
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model = PerformanceNet(self.model_cfg, device=self.device, generator=gen)
            if comm.group_size(self._model_group) > 1:
                self.model.shard_tensor_parallel_(self._model_group)
            named = list(self.model.named_parameters())
            if self.mesh is not None and self.cfg.zero_opt:
                self.optimizer = optim.ZeroOptimizer(named, self.cfg, self.scheduler.lr,
                                                     self.device, self._batch_group)
            else:
                self.optimizer = optim.build_optimizer(named, self.cfg, self.scheduler.lr,
                                                       self.device)
        return self.model, self.optimizer

    def _names(self) -> list[str]:
        return [n for n, _ in self.model.named_parameters()]

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        """The EMA of the weights under the model's state_dict keys, whole
        (raises ``ValueError`` without ``ema_decay``)."""
        return self._whole(dict(zip(self._names(), optim.get_param_ema(self.optimizer))))

    @contextlib.contextmanager
    def ema_weights(self):
        """The model holds the EMA weights inside the block (no copy: the
        parameters' data are swapped and swapped back)."""
        params = list(self.model.parameters())
        saved = [p.data for p in params]
        for p, e in zip(params, optim.get_param_ema(self.optimizer)):
            p.data = e
        try:
            yield self.model
        finally:
            for p, s in zip(params, saved):
                p.data = s

    def _tp_map(self, tensors: dict, fn) -> dict:
        """``tensors`` keyed by parameter name, ``fn(t, dim)`` applied to the
        tensor-parallel ones (gather or slice over the model axis)."""
        dims = self.model.tp_dims()
        return {k: fn(v, dims[k]) if k in dims else v for k, v in tensors.items()}

    def _whole(self, tensors: dict) -> dict:
        return self._tp_map(tensors, lambda t, d: comm.all_gather_cat(t, self._model_group, d))

    def _local(self, tensors: dict) -> dict:
        return self._tp_map(tensors, lambda t, d: comm.local_slice(t, self._model_group, d)
                            .contiguous())

    def _opt_state(self) -> dict:
        """``optim.export_state`` with whole tensors (ZeRO and TP gathered)."""
        state = optim.export_state(self.optimizer, self._names())
        return {k: self._whole(v) if k in ("mu", "nu", "ema", "acc") and v is not None else v
                for k, v in state.items()}

    def state_dict(self, epoch: int) -> dict:
        """The checkpoint state, under the JAX package's keys, with whole
        tensors; the optimizer state is ``optim.export_state``'s, keyed by
        parameter name. On a mesh every rank calls it (it gathers)."""
        state = {"params": self.model.full_state_dict(), "opt_state": self._opt_state(),
                 "epoch": epoch, "scheduler": self.scheduler.state_dict()}
        if self.cfg.ema_decay is not None:
            state["ema_params"] = self.ema_state_dict()
        return state

    def jax_state_dict(self, epoch: int) -> dict:
        """The checkpoint state in the JAX layout (flax param trees, the
        optax state of the JAX ``Trainer`` with this config): what
        ``save_checkpoint(..., fmt="msgpack")`` writes and the JAX
        package's ``restore_checkpoint`` reads. On a mesh every rank calls
        it."""
        return weights.to_jax_state(self.state_dict(epoch), self.cfg)

    def _local_opt(self):
        """The optimizer that holds this rank's state: ZeRO's inner one."""
        return self.optimizer.inner if isinstance(self.optimizer, optim.ZeroOptimizer) \
            else self.optimizer

    def sharded_state_dict(self, epoch: int) -> dict:
        """``state_dict``'s keys and layout with this rank's own tensors (its
        TP slices, its ZeRO slices of the optimizer state), which share the
        live ones: no collective. On a mesh each is a DTensor on
        ``parallel/mesh.checkpoint_mesh`` that places it in the whole
        tensor; with no mesh they are the whole tensors."""
        names = self._names()
        state = {"params": self.model.state_dict(),
                 "opt_state": optim.export_state(self._local_opt(), names),
                 "epoch": epoch, "scheduler": self.scheduler.state_dict()}
        if self.cfg.ema_decay is not None:
            state["ema_params"] = dict(zip(names, optim.get_param_ema(self._local_opt())))
        if self.mesh is None:
            return state
        cmesh = pmesh.checkpoint_mesh(self.mesh)
        tp = self.model.tp_dims()
        zero = (dict(zip(names, self.optimizer.dims))
                if isinstance(self.optimizer, optim.ZeroOptimizer) else {})

        def place(tensors: dict, sliced: bool) -> dict:
            return {k: DTensor.from_local(
                v, cmesh, pmesh.placements(cmesh, tp.get(k), zero.get(k) if sliced else None),
                run_check=False) for k, v in tensors.items()}

        state["params"] = place(state["params"], False)
        state["opt_state"] = {k: place(v, True) if k in ("mu", "nu", "ema", "acc")
                              and v is not None else v
                              for k, v in state["opt_state"].items()}
        if "ema_params" in state:
            state["ema_params"] = place(state["ema_params"], True)
        return state

    def orbax_state(self, epoch: int) -> dict:
        """``jax_state_dict``'s tree with no collective: on a mesh each
        tensor leaf is this rank's block of it (``orbax_format.Shard``:
        ``sharded_state_dict``'s slices, permuted into the JAX layout as
        the whole is), what ``save_checkpoint_orbax`` writes on a mesh;
        with no mesh the whole tensors. On a mesh every rank calls it."""
        state = self.sharded_state_dict(epoch)
        if self.mesh is None:
            return weights.to_jax_state(state, self.cfg)
        return weights.to_jax_state(ckpt.tree_map(
            lambda v: ckpt.shard_of(v) if isinstance(v, DTensor) else v, state), self.cfg,
            leaf=lambda b, dims: b.permute(dims))

    def load_orbax_sharded(self, path: str, stats: dict | None = None) -> int:
        """Restore an ``.orbax`` (written by the JAX package or the port, on
        any mesh) into this Trainer's own placement: each rank reads only
        the chunks that meet its blocks (``orbax_state``'s), and no
        ``ema_params`` (the EMA is in the optimizer state). On a mesh
        every rank calls it. Returns the epoch."""
        template = {k: v for k, v in self.orbax_state(0).items() if k != "ema_params"}
        state = ckpt.restore_checkpoint_orbax_sharded(path, template, stats)
        self.model.load_state_dict(weights.from_jax_params(state["params"]))
        optim.import_state(self._local_opt(), weights.from_jax_opt_state(state["opt_state"]),
                           self._names())
        self.scheduler.load_state_dict(state["scheduler"])
        return state["epoch"]

    def load_sharded_state(self, path: str) -> int:
        """Restore a ``.dcp`` (``sharded_state_dict``'s layout, written on
        any mesh) into this Trainer's own placement: each rank reads only
        its slices. On a mesh every rank calls it. Returns the epoch."""
        def empty(v):
            if isinstance(v, DTensor):
                return DTensor.from_local(torch.empty_like(v.to_local()), v.device_mesh,
                                          v.placements, run_check=False)
            return torch.empty_like(v) if isinstance(v, torch.Tensor) else v

        template = ckpt.tree_map(empty, self.sharded_state_dict(0))
        state = ckpt.tree_map(lambda v: v.to_local() if isinstance(v, DTensor) else v,
                               ckpt.restore_checkpoint_sharded(path, template))
        self.model.load_state_dict(state["params"])
        optim.import_state(self._local_opt(), state["opt_state"], self._names())
        self.scheduler.load_state_dict(state["scheduler"])
        return state["epoch"]

    def load_state(self, state: dict) -> None:
        """Load a ``state_dict`` (from a .pt) or a JAX-layout state (from a
        msgpack or orbax directory the JAX package or ``jax_state_dict``
        wrote). On a mesh
        each rank keeps its slices of the whole tensors."""
        if "params" in state["params"]:  # a flax tree: {"params": {...}}
            self.model.load_state_dict(weights.from_jax_params(state["params"]))
            self._import_opt(weights.from_jax_opt_state(state["opt_state"]))
        else:
            self.model.load_state_dict(state["params"])
            self._import_opt(state["opt_state"])
        self.scheduler.load_state_dict(state["scheduler"])

    def _import_opt(self, opt_state: dict) -> None:
        opt_state = {k: self._local(v) if k in ("mu", "nu", "ema", "acc") and v is not None
                     else v for k, v in opt_state.items()}
        optim.import_state(self.optimizer, opt_state, self._names())

    def set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def next_dropout_seed(self) -> int:
        lo, hi = torch.randint(0, 2**32, (2,), generator=self.dropout_gen).tolist()
        return lo | (hi << 32)

    # ---- the batch axes -------------------------------------------------
    def shard_batch(self, batch):
        """This rank's share of a global batch (a dict of arrays or tensors,
        or one of them): rows [r * B/n, (r + 1) * B/n) for batch rank r of
        n. The batch itself with no mesh."""
        if isinstance(batch, dict):
            return {k: self.shard_batch(v) for k, v in batch.items()}
        n = self.n_batch_shards
        if n == 1:
            return batch
        if batch.shape[0] % n:
            raise ValueError(f"a batch of {batch.shape[0]} does not split over "
                             f"{n} batch ranks")
        size = batch.shape[0] // n
        return batch[self.batch_rank * size:(self.batch_rank + 1) * size]

    def _batch_weights(self, weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(this rank's weight sum, the global batch's), each at least 1:
        a rank's weighted-mean loss times their ratio is its share of the
        global weighted mean."""
        w = weight.sum().float()
        total = comm.all_reduce_(w.clone(), self._batch_group)
        return torch.clamp(w, min=1.0), torch.clamp(total, min=1.0)

    # ---- steps --------------------------------------------------------
    def loss(self, batch: dict, dropout_seed: int) -> torch.Tensor:
        with profiling.span("train.forward"):
            pred = self.model(batch["midi"], batch["cond"], batch["onoff"],
                              deterministic=False, dropout_seed=dropout_seed)
        with profiling.span("train.loss"):
            loss = losses.l1_loss(pred, batch["target"], batch["weight"])
            if self.cfg.spectral_loss_weight > 0.0:
                loss = loss + self.cfg.spectral_loss_weight * losses.multiscale_spectral_loss(
                    pred, batch["target"], batch["weight"], mode=self.cfg.spectral_loss_mode)
        return loss

    def train_step(self, batch: dict, dropout_seed: int) -> torch.Tensor:
        """One optimizer call on ``batch`` (device tensors; on a mesh this
        rank's share, ``shard_batch``): an update, or with ``grad_accum =
        k`` one of k microbatches, whose k-th applies the mean. Returns the
        (global) loss as a device scalar. Traced, it is the span
        ``train.step`` (a new step, counting the allocator's calls) around
        ``train.forward``, ``train.loss``, ``train.backward`` (the
        gradients' all-reduce included) and ``train.optimizer``."""
        with profiling.span("train.step", step=True):
            self.optimizer.zero_grad(set_to_none=True)
            w, total = self._batch_weights(batch["weight"])
            loss = self.loss(batch, fold_seed(dropout_seed, self.batch_rank)) * (w / total)
            with profiling.span("train.backward"):
                loss.backward()
                for p in self.model.parameters():
                    if p.grad is not None:
                        comm.all_reduce_(p.grad, self._batch_group)
            with profiling.span("train.optimizer"):
                self.optimizer.step()
            return comm.all_reduce_(loss.detach(), self._batch_group)

    @torch.no_grad()
    def eval_step(self, batch: dict) -> torch.Tensor:
        """MSE of the (global) batch, weight-masked; on a mesh ``batch`` is
        this rank's share."""
        pred = self.model(batch["midi"], batch["cond"], batch["onoff"], deterministic=True)
        loss = losses.mse_loss(pred, batch["target"], batch["weight"])
        w, total = self._batch_weights(batch["weight"])
        return comm.all_reduce_(loss * (w / total), self._batch_group)

    def _weight_sum(self, weight: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce_(weight.sum().float(), self._batch_group)

    def train_step_resident(self, audio, roll, onoff, idx, cond_idx, style,
                            dropout_seed: int) -> torch.Tensor:
        """``train_step`` on a batch gathered and STFT'd on the device from
        a ``DeviceDataStore``'s tensors at the (global) index vectors; on a
        mesh the tensors are a replicated store's and each rank gathers its
        share."""
        idx, cond_idx, style = (self.shard_batch(v) for v in (idx, cond_idx, style))
        return self.train_step(gather_batch(audio, roll, onoff, idx, cond_idx, style),
                               dropout_seed)

    @torch.no_grad()
    def eval_step_resident(self, audio, roll, onoff, idx, cond_idx, style,
                           weight=None) -> torch.Tensor:
        idx, cond_idx, style = (self.shard_batch(v) for v in (idx, cond_idx, style))
        weight = None if weight is None else self.shard_batch(weight)
        return self.eval_step(gather_batch(audio, roll, onoff, idx, cond_idx, style,
                                           weight=weight))

    # ---- epochs -------------------------------------------------------
    def _train_batches(self, dataset: ChunkDataset) -> Iterator[dict]:
        """One epoch of train batches on the device: from the native
        assembler (its own draw order) or from Python assembly."""
        bs = self.cfg.batch_size
        if not self.use_native_loader:
            yield from device_prefetch(
                map(self.shard_batch, dataset.epoch_batches(bs, shuffle=True, drop_last=True)),
                self.device, stream_dtype=self.stream_dtype)
            return
        on_card = self.device.type == "cuda"
        asm = dataset.native_assembler(bs, pin_memory=on_card)
        for batch in asm.epoch_batches(shuffle=True):
            dev = stage_batch(self.shard_batch(batch), self.device, self.stream_dtype)
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
            batch = store.local_batch(idx, cond_idx, style)
            losses_dev.append(self.train_step(batch, self.next_dropout_seed()))
        return self._epoch_report(epoch, losses_dev, t0, exp, ", device-resident")

    def evaluate(self, dataset: ChunkDataset, exp=None) -> float:
        """Weighted-exact MSE over the whole split (reference test(),
        train.py:152-170); the last batch is padded and masked."""
        losses_dev, weights = [], []
        for batch in device_prefetch(
                map(self.shard_batch,
                    dataset.epoch_batches(self.cfg.batch_size, shuffle=False, drop_last=False)),
                self.device, stream_dtype=self.stream_dtype):
            losses_dev.append(self.eval_step(batch))
            weights.append(self._weight_sum(batch["weight"]))
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
            batch = store.local_batch(idx, cond_idx, style, weight)
            losses_dev.append(self.eval_step(batch))
            weights.append(self._weight_sum(batch["weight"]))
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
        a notice. On a mesh the store is whole on every rank
        (``store_sharding="replicated"``) or its rows are split over the
        data axis (``"data"``); with no mesh both are one device's store.
        Every rank of a mesh reads the data; rank 0 writes the experiment
        directory, its logs and the checkpoints.

        ``checkpoint_format``: "torch" (``checkpoint-{epoch}.pt``),
        "msgpack" (the JAX package's format, ``jax_state_dict``), "dcp"
        (``checkpoint-{epoch}.dcp``, ``sharded_state_dict``: written in the
        background while training goes on, each rank its own slices, from
        page-locked host buffers the run reuses and frees when it ends; the
        next save and the end of ``fit`` join the write) or "orbax" (the
        JAX package's ``checkpoint-{epoch}.orbax``, ``orbax_state``,
        written in the background in the same way, each rank its own
        blocks on a mesh). A resume restores a ``.dcp``, and on a mesh an
        ``.orbax``, into this Trainer's placement, each rank reading only
        its slices, and reads any other format whole (each rank keeps its
        slices). With
        ``ema_decay`` set the EMA weights are evaluated, ranked and written
        as ``ema_params``.
        """
        check_placement(store_sharding)
        if checkpoint_format not in (*ckpt.FORMATS, "dcp", "orbax"):
            raise ValueError(f"unknown checkpoint_format {checkpoint_format!r}")
        if self.is_main:
            os.makedirs(self.exp_root, exist_ok=True)
            if not resume:
                os.makedirs(self.exp_dir)  # same error-on-exists semantics (train.py:183)
        if self.mesh is not None:
            dist.barrier()
        store = test_store = train_ds = test_ds = None
        if device_resident:
            store_kw = {"store_sharding": store_sharding, "device": self.device,
                        "mesh": self.mesh}
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
                if path.endswith(".dcp"):
                    start_epoch = self.load_sharded_state(path)
                elif path.endswith(".orbax") and self.mesh is not None:
                    start_epoch = self.load_orbax_sharded(path)
                else:
                    state = ckpt.restore_checkpoint(path, self.device)
                    self.load_state(state)
                    start_epoch = state["epoch"]
                exp = ckpt.ExperimentState.load(self.exp_dir)
                print(f"resumed from {path} at epoch {start_epoch}")

        self.dropout_gen = torch.Generator().manual_seed(self.cfg.seed)
        metrics = MetricsLogger(os.path.join(self.exp_dir, "metrics.jsonl")
                                if self.is_main else None)
        staging: dict = {}  # host buffers of the background saves, reused for the run
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
                # with an EMA, serving loads the EMA weights (--use-ema), so
                # best-epoch selection ranks them (JAX loop.py:508-516)
                ema = (self.ema_weights() if self.cfg.ema_decay is not None
                       else contextlib.nullcontext())
                with ema:
                    if test_store is not None:
                        test_loss = self.evaluate_resident(test_store, exp=exp)
                    else:
                        test_loss = self.evaluate(test_ds, exp=exp)
                exp.test_loss_history.append(test_loss)
                self.set_lr(self.scheduler.step(test_loss))
                metrics.log("eval", epoch=epoch, test_loss=test_loss, lr=self.scheduler.lr)
                if test_loss < exp.best_loss:
                    print("saving model")
                    if checkpoint_format == "dcp":  # every rank, its own slices
                        ckpt.save_checkpoint_sharded(self.exp_dir, epoch + 1,
                                                     self.sharded_state_dict(epoch + 1),
                                                     buffers=staging)
                    elif checkpoint_format == "orbax":  # every rank, its own blocks
                        ckpt.save_checkpoint_orbax(self.exp_dir, epoch + 1,
                                                   self.orbax_state(epoch + 1), buffers=staging)
                    else:
                        state = (self.jax_state_dict(epoch + 1) if checkpoint_format == "msgpack"
                                 else self.state_dict(epoch + 1))
                        if self.is_main:
                            ckpt.save_checkpoint(self.exp_dir, epoch + 1, state,
                                                 checkpoint_format)
                    exp.best_loss = test_loss
                    exp.best_epoch = epoch + 1
                    if self.is_main:
                        exp.save(self.exp_dir)
                    metrics.log("checkpoint", epoch=epoch + 1, best_loss=test_loss)
        if checkpoint_format in ("dcp", "orbax"):
            ckpt.wait_for_async_saves()
            staging.clear()  # the run's page-locked copy of the state
        metrics.close()
        if self.mesh is not None:
            dist.barrier()  # the checkpoints are written before any rank returns
        return self.model, exp
