"""Checkpoint save/restore and the reference's hyperparams.json contract.

Counterpart of the JAX package's ``train/checkpoint.py`` (:27-70, :180-220).
The reference saves ``{'epoch', 'state_dict', 'optimizer'}`` tar files on a
test-loss improvement, and a hyperparams.json whose ``best_epoch`` names the
checkpoint inference loads (model/train.py:202-208, inference.py:120-122).
This module keeps that contract (``ExperimentState`` writes the same field
names) and the JAX package's resume path.

Four formats:
  - ``checkpoint-{epoch}.pt`` (``torch.save``, the port's default) holds the
    JAX state's keys with the port's values: ``{"params": model
    state_dict (reference key names), "opt_state": ``optim.export_state``
    (the optimizer's state keyed by parameter name), "epoch",
    "scheduler"}``, plus ``"ema_params"`` where the
    run kept an EMA; it is read through a memory map, so the keys a
    caller does not ask for are never read (serving skips the Adam
    moments);
  - ``checkpoint-{epoch}.msgpack`` is the JAX package's flax msgpack,
    read and written by ``train/flax_msgpack.py`` (no flax, no msgpack):
    its trees are in the JAX layout (``compat/weights.py`` translates).
    ``restore_checkpoint`` returns such a file's tree as it stands; the
    ``Trainer`` and the synthesizer translate it;
  - ``checkpoint-{epoch}.dcp`` is a directory written by
    ``torch.distributed.checkpoint`` (DCP), the counterpart of the JAX
    package's orbax path (its ``checkpoint.py:73-177``): the ``.pt``'s keys
    and values, where on a mesh each rank writes only the slices it holds
    (DTensors placed by ``parallel/mesh.placements``; a replicated tensor
    is written once) and nothing is gathered. ``save_checkpoint_sharded``
    copies the state to page-locked host memory (the caller's buffers,
    reused from save to save, or new ones freed when the write ends) and
    returns; the write goes on in a background thread into
    ``checkpoint-{epoch}.dcp.tmp``, which is renamed on commit, so a save
    that never finished never appears under the checkpoint's name. The
    next save, a restore and ``wait_for_async_saves`` join it. A restore
    reads only the slices its template's placement needs, on any mesh;
    ``restore_checkpoint(path, keys=("params",))`` reads that one tree and
    nothing else;
  - ``checkpoint-{epoch}.orbax`` is the directory the JAX package's
    ``save_checkpoint_sharded`` writes (orbax: an OCDBT store of zarr
    arrays), read and written by ``train/orbax_format.py`` (no orbax,
    tensorstore or JAX; zstd through ``train/zstd.py``). Like a
    ``.msgpack`` its tree is in the JAX layout and ``restore_checkpoint``
    returns it as it stands, ``keys=`` reading only those trees' chunks.
    ``save_checkpoint_orbax`` writes one in the background, as
    ``save_checkpoint_sharded`` does a ``.dcp``: from whole tensors on one
    device (``Trainer.jax_state_dict``), or on a mesh from each rank's own
    blocks (``orbax_format.Shard``s, ``Trainer.orbax_state``), where every
    rank writes the blocks it holds (a replicated one once) into its own
    ``ocdbt.process_{rank}/`` and nothing is gathered but the lists of
    keys; rank 0 then commits. ``restore_checkpoint_orbax_sharded`` reads
    a template's blocks, each rank only the chunks that meet its own, on
    any mesh.
Where one epoch has several, the ``.pt`` wins, then the ``.msgpack``, then
the ``.dcp``, then the ``.orbax``.
"""
from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import glob
import json
import os
import re
import shutil
import time
from typing import Any, Iterable

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..compat import weights
from ..parallel import mesh as pmesh
from . import flax_msgpack, orbax_format

FORMATS = {"torch": "pt", "msgpack": "msgpack"}
SHARDED_EXT = "dcp"
ORBAX_EXT = "orbax"


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
    """``checkpoint-{epoch}`` with the extension of ``fmt`` ("torch",
    "msgpack", "dcp" or "orbax")."""
    ext = {"dcp": SHARDED_EXT, "orbax": ORBAX_EXT}.get(fmt) or FORMATS[fmt]
    return os.path.join(exp_dir, f"checkpoint-{epoch}.{ext}")


def save_checkpoint(exp_dir: str, epoch: int, state: dict, fmt: str = "torch") -> str:
    """Write ``state`` as checkpoint-{epoch}.pt (``fmt="torch"``) or as
    flax msgpack, checkpoint-{epoch}.msgpack (``fmt="msgpack"``; ``state``
    in the JAX layout, e.g. ``Trainer.jax_state_dict``, written in flax's
    state-dict layout, ``weights.flax_state_dict``), via a temporary
    file, so a crash mid-write never leaves a truncated checkpoint under
    its name."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown checkpoint format {fmt!r}; 'torch' or 'msgpack' "
                         "('dcp': save_checkpoint_sharded; 'orbax': save_checkpoint_orbax)")
    path = checkpoint_path(exp_dir, epoch, fmt)
    if fmt == "msgpack":
        return flax_msgpack.dump(weights.flax_state_dict(state), path)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def restore_checkpoint(path: str, device="cpu", keys: Iterable[str] | None = None
                       ) -> dict[str, Any]:
    """The dict a checkpoint holds, only its top-level ``keys`` where given
    (the rest is not read; a key it lacks raises ``ValueError``): a ``.pt``
    or ``.dcp`` with its tensors whole, on ``device``; a ``.msgpack`` or an
    ``.orbax`` as its flax tree of CPU tensors (the JAX layout)."""
    jax_layout = path.endswith((".msgpack", f".{ORBAX_EXT}"))
    if path.endswith(".msgpack"):
        state = flax_msgpack.load(path, keys)
    elif path.endswith(f".{ORBAX_EXT}"):
        _SAVER.wait()
        state = orbax_format.read(path, keys)
    elif path.endswith(f".{SHARDED_EXT}"):
        state = _restore_host(path, keys)
    else:
        # mapped, not read: only the tensors kept below are paged in
        state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if keys is not None:
            state = {k: state[k] for k in keys if k in state}
    for key in keys or ():
        if key not in state:
            raise ValueError(
                f"checkpoint {path} has no '{key}' tree"
                + (" — was --ema-decay set during training?" if key == "ema_params" else ""))
    if jax_layout:
        return state
    dev = torch.device(device)
    return tree_map(lambda v: v.to(dev) if isinstance(v, torch.Tensor) else v, state)


# ---- sharded asynchronous checkpoints (torch.distributed.checkpoint) -------

class _AsyncSaver:
    """The one background write in flight and the gloo group DCP
    coordinates the ranks of a mesh over (the training loop's own
    collectives never share it). The host copy a write was staged into is
    referenced only by the write (and by the caller's ``buffers``): it is
    freed when the write ends."""

    def __init__(self):
        self.executor: concurrent.futures.ThreadPoolExecutor | None = None
        self.pending: tuple[concurrent.futures.Future, Any] | None = None
        self.groups: dict[Any, Any] = {}

    def group(self):
        """The checkpoint group of the current default group (made once,
        by every rank)."""
        world = dist.group.WORLD
        if world not in self.groups:
            self.groups[world] = dist.new_group(backend="gloo")
        return self.groups[world]

    def wait(self) -> None:
        if self.pending is None:
            return
        future, group = self.pending
        self.pending = None
        future.result()  # a failed write raises here
        if group is not None:
            dist.barrier(group=group)  # the coordinator has committed

    @staticmethod
    def stage(state: dict, buffers: dict) -> dict:
        """A host copy of ``state`` (page-locked where it comes from the
        card) that no later in-place update of its tensors (the next
        optimizer step) reaches; on return the copies from the card have
        completed. The copy's buffers are taken from ``buffers`` where one
        of the same shape and dtype is there, and left in it."""
        on_card = []

        def copy_leaf(path, v):
            if isinstance(v, orbax_format.Shard):  # only a block this rank writes is copied
                return dataclasses.replace(v, data=copy_leaf(path, v.data) if v.write else None)
            if not isinstance(v, torch.Tensor):
                return copy.deepcopy(v)
            local = v.to_local() if isinstance(v, DTensor) else v
            buf = buffers.get(path)
            if buf is None or buf.shape != local.shape or buf.dtype != local.dtype:
                buf = torch.empty(local.shape, dtype=local.dtype, pin_memory=local.is_cuda)
                buffers[path] = buf
            buf.copy_(local.detach(), non_blocking=local.is_cuda)
            if local.is_cuda:
                on_card.append(local.device)
            if isinstance(v, DTensor):
                mesh = v.device_mesh
                host = DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names,
                                  _init_backend=False)
                return DTensor.from_local(buf, host, v.placements, run_check=False)
            return buf

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if isinstance(tree, (tuple, list)):
                return type(tree)(walk(v, path + (str(i),)) for i, v in enumerate(tree))
            return copy_leaf(path, tree)

        staged = walk(state, ())
        for dev in set(on_card):
            torch.cuda.synchronize(dev)
        return staged


_SAVER = _AsyncSaver()


def _has(tree, kind) -> bool:
    if isinstance(tree, dict):
        return any(_has(v, kind) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_has(v, kind) for v in tree)
    return isinstance(tree, kind)



def _is_coordinator(group) -> bool:
    return group is None or dist.get_rank(group) == 0


def sharded_checkpoint_path(exp_dir: str, epoch: int) -> str:
    return os.path.abspath(checkpoint_path(exp_dir, epoch, "dcp"))


def _flush(box: list, tmp: str, path: str, group) -> str:
    """Write the staged state ``box`` holds, then commit. The box is
    emptied so that this frame holds the state's only reference: it is
    freed before the write's future completes."""
    staged = box.pop()
    dcp.save(staged, storage_writer=dcp.FileSystemWriter(tmp), process_group=group,
             no_dist=group is None)
    del staged
    if _is_coordinator(group):  # every rank's files are in: commit
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    return path


def save_checkpoint_sharded(exp_dir: str, epoch: int, state: dict,
                            wait: bool = False, buffers: dict | None = None) -> str:
    """Write ``state`` as ``checkpoint-{epoch}.dcp``, each rank its own
    slices: tensors are whole (one device) or DTensors (a mesh; every rank
    of it calls this). Returns once ``state`` is copied to the host; the
    write goes on in a background thread and commits by renaming
    ``checkpoint-{epoch}.dcp.tmp``. The next save, a restore and
    ``wait_for_async_saves`` join it; ``wait=True`` joins it here. An
    existing checkpoint of that epoch is replaced.

    ``buffers``: a dict the caller keeps from save to save (``fit`` keeps
    one for its run): the host copy's page-locked buffers are reused from
    it and stay allocated while the caller holds it (the state's size:
    8.78 GB at full width with fused Adam). Where None the copy is
    allocated anew and freed when the write ends."""
    _SAVER.wait()
    group = _SAVER.group() if _has(state, DTensor) else None
    path = sharded_checkpoint_path(exp_dir, epoch)
    tmp = f"{path}.tmp"
    if _is_coordinator(group) and os.path.exists(tmp):
        shutil.rmtree(tmp)  # a save that never committed
    if group is not None:
        dist.barrier(group=group)
    box = [_SAVER.stage(state, {} if buffers is None else buffers)]
    if _SAVER.executor is None:
        _SAVER.executor = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="checkpoint-flush")
    _SAVER.pending = (_SAVER.executor.submit(_flush, box, tmp, path, group), group)
    del box
    if wait:
        _SAVER.wait()
    return path


def _flush_orbax(box: list, tmp: str, path: str, group) -> str:
    """Write this rank's part of the staged state ``box`` holds
    (``orbax_format.write_shards``), gather every rank's entries over
    ``group``, and let the coordinator commit. A rank whose write failed
    makes every rank raise, and nothing is committed; so does a failed
    commit. The box is emptied as in ``_flush``."""
    staged = box.pop()
    rank = 0 if group is None else dist.get_rank(group)
    leaves = orbax_format.layout(staged)
    t0 = time.time_ns()
    err = entries = None
    try:
        entries = orbax_format.write_shards(tmp, rank, staged)
    except Exception as e:  # reported on every rank below
        err = f"rank {rank}: {type(e).__name__}: {e}"
    del staged
    gathered = [(err, entries)]
    if group is not None:
        gathered = [None] * dist.get_world_size(group)
        dist.all_gather_object(gathered, (err, entries), group=group)
    errors = [e for e, _ in gathered if e is not None]
    if errors:
        if _is_coordinator(group):
            shutil.rmtree(tmp, ignore_errors=True)
        raise OSError(f"orbax save of {path} failed, nothing committed: {'; '.join(errors)}")
    status = [None]
    if _is_coordinator(group):
        try:
            orbax_format.commit(tmp, path, leaves, [e for _, e in gathered], t0)
        except Exception as e:
            status = [f"{type(e).__name__}: {e}"]
    if group is not None:
        dist.broadcast_object_list(status, src=dist.get_global_rank(group, 0), group=group)
    if status[0] is not None:
        raise OSError(f"orbax save of {path} failed to commit: {status[0]}")
    return path


def save_checkpoint_orbax(exp_dir: str, epoch: int, state: dict, wait: bool = False,
                          buffers: dict | None = None) -> str:
    """Write ``state`` (the JAX layout) as ``checkpoint-{epoch}.orbax``, the
    counterpart of the JAX package's ``save_checkpoint_sharded``. Its
    leaves are whole (``Trainer.jax_state_dict``; one process writes
    them), or on a mesh each rank's ``orbax_format.Shard``s
    (``Trainer.orbax_state``; every rank calls this and writes the blocks
    it holds, a replicated block by one rank, into its own
    ``ocdbt.process_{rank}/``; then rank 0 commits). Returns once the
    blocks this rank writes are copied to the host (into ``buffers``
    where given, as in ``save_checkpoint_sharded``); the write goes on in
    the background into ``checkpoint-{epoch}.orbax.tmp``, renamed on
    commit. The next save, a restore and ``wait_for_async_saves`` join
    it; ``wait=True`` joins it here."""
    _SAVER.wait()
    group = _SAVER.group() if _has(state, orbax_format.Shard) and dist.is_initialized() \
        else None
    path = os.path.abspath(checkpoint_path(exp_dir, epoch, "orbax"))
    tmp = f"{path}.tmp"
    if _is_coordinator(group) and os.path.exists(tmp):
        shutil.rmtree(tmp)  # a save that never committed
    if group is not None:
        dist.barrier(group=group)
    box = [_SAVER.stage(state, {} if buffers is None else buffers)]
    if _SAVER.executor is None:
        _SAVER.executor = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="checkpoint-flush")
    _SAVER.pending = (_SAVER.executor.submit(_flush_orbax, box, tmp, path, group), None)
    del box
    if wait:
        _SAVER.wait()
    return path


def wait_for_async_saves() -> None:
    """Join the background write of the last ``save_checkpoint_sharded``
    or ``save_checkpoint_orbax`` (on a mesh every rank calls it); it raises
    what the write raised."""
    _SAVER.wait()


def _tree_paths(tree, path=()) -> set[tuple]:
    if isinstance(tree, dict):
        return set().union(*(_tree_paths(v, path + (k,)) for k, v in tree.items()))
    return {path}


def _metadata(path: str):
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    return dcp.FileSystemReader(path).read_metadata()


def restore_checkpoint_sharded(path: str, template: dict) -> dict:
    """Fill ``template`` from the ``.dcp`` at ``path`` and return it. Its
    tensors (whole, or DTensors: each rank reads only the slices its
    placement holds, on whatever mesh, not only the one that wrote it) are
    written in place on their devices; its other leaves are replaced by
    the saved values. A template key the checkpoint lacks raises
    ``ValueError``; keys it does not name are not read."""
    _SAVER.wait()
    missing = _tree_paths(template) - set(_metadata(path).planner_data.values())
    if missing:
        raise ValueError(f"checkpoint {path} lacks {sorted('.'.join(p) for p in missing)}: "
                         "it was written for another model or other optimizer options")
    group = _SAVER.group() if _has(template, DTensor) else None
    dcp.load(template, storage_reader=dcp.FileSystemReader(path), process_group=group,
             no_dist=group is None)
    return template


def _restore_host(path: str, keys: Iterable[str] | None = None) -> dict:
    """The ``.dcp``'s trees under top-level ``keys`` (all where None) as
    whole CPU tensors, with no template: shapes and dtypes come from the
    checkpoint's metadata. The other trees are not read."""
    _SAVER.wait()
    md = _metadata(path)
    tree: dict = {}
    for fqn, p in md.planner_data.items():
        if keys is not None and p[0] not in keys:
            continue
        meta = md.state_dict_metadata[fqn]
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = (torch.empty(meta.size, dtype=meta.properties.dtype)
                       if isinstance(meta, TensorStorageMetadata) else None)
    if tree:
        dcp.load(tree, storage_reader=dcp.FileSystemReader(path), no_dist=True)
    return tree


def shard_of(t: DTensor) -> orbax_format.Shard:
    """This rank's block of the DTensor ``t`` (on a checkpoint mesh), its
    data the local tensor (``shard_box``)."""
    offset, size, write = pmesh.shard_box(t.device_mesh.mesh.numpy(), dist.get_rank(),
                                          t.placements, tuple(t.shape))
    return orbax_format.Shard(t.to_local(), tuple(t.shape), offset, size, t.dtype, write)


def restore_checkpoint_orbax_sharded(path: str, template: dict, stats: dict | None = None
                                     ) -> dict:
    """The orbax directory at ``path`` read into ``template`` (the JAX
    layout; only its top-level keys are read), the counterpart of the JAX
    package's ``restore_checkpoint_sharded``: an ``orbax_format.Shard``
    leaf (a rank's block, e.g. ``shard_of`` a DTensor, or
    ``Trainer.orbax_state``'s) comes back as its block, a CPU tensor read
    from the chunks that meet it and no other, whatever grid of chunks the
    writer's mesh gave the array; the other leaves come back whole as
    saved. A leaf or a top-level key the checkpoint lacks raises
    ``ValueError``. ``stats``: as ``orbax_format.read``."""
    _SAVER.wait()
    regions = {k: (b.offset, b.size) for k, b in orbax_format.shards(template).items()}
    tree = orbax_format.read(path, keys=list(template), stats=stats, regions=regions)
    missing = set(template) - set(tree)
    if missing:
        raise ValueError(f"checkpoint {path} has no {sorted(missing)}")
    return tree


# the JAX package's names for the host reads of an orbax directory (here
# of a .dcp too)
def restore_checkpoint_sharded_host(path: str) -> dict:
    return restore_checkpoint(path)


def restore_params_sharded_host(path: str, key: str = "params") -> dict:
    return restore_checkpoint(path, keys=(key,))[key]


def _epochs(exp_dir: str, ext: str) -> dict[int, str]:
    out = {}
    for p in glob.glob(os.path.join(exp_dir, f"checkpoint-*.{ext}")):
        m = re.search(rf"checkpoint-(\d+)\.{ext}$", p)
        if m:
            out[int(m.group(1))] = p
    return out


def latest_checkpoint(exp_dir: str) -> tuple[str, int] | None:
    """(path, epoch) of the newest committed checkpoint in exp_dir (for one
    epoch the .pt, else the .msgpack, else the .dcp, else the .orbax: an
    orbax checkpoint of the same epoch as a msgpack loses to it, as in the
    JAX package's ``latest_checkpoint``; a ``.dcp.tmp`` or ``.orbax.tmp``
    that never committed is no checkpoint), or None."""
    found = {**_epochs(exp_dir, ORBAX_EXT), **_epochs(exp_dir, SHARDED_EXT),
             **_epochs(exp_dir, "msgpack"), **_epochs(exp_dir, "pt")}
    if found:
        epoch = max(found)
        return found[epoch], epoch
    return None


def best_checkpoint(exp_dir: str) -> tuple[str, int]:
    """The checkpoint inference should load, via hyperparams.json's
    best_epoch: ``checkpoint-{best}.pt``, else ``.msgpack``, else ``.dcp``,
    else ``.orbax``, else the reference's own ``checkpoint-{best}.tar``
    (train.py:202-204), else the newest committed checkpoint (a best-epoch
    save lost in a crash, or an asynchronous one that never committed;
    with a warning): the JAX package's order, with the port's formats
    first."""
    with open(os.path.join(exp_dir, "hyperparams.json")) as f:
        best = json.load(f)["best_epoch"]  # all inference reads (inference.py:120-122)
    for path in (checkpoint_path(exp_dir, best), checkpoint_path(exp_dir, best, "msgpack"),
                 checkpoint_path(exp_dir, best, "dcp"), checkpoint_path(exp_dir, best, "orbax"),
                 os.path.join(exp_dir, f"checkpoint-{best}.tar")):
        if os.path.exists(path):
            return path, best
    latest = latest_checkpoint(exp_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint in {exp_dir} (best_epoch={best})")
    print(f"warning: best_epoch={best} checkpoint missing; using {latest[0]}")
    return latest
