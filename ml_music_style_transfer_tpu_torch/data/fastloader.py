"""ctypes binding of the native batch assembler (``csrc/fastloader.cpp``):
the port of the JAX package's ``data/fastloader.py`` (``NativeBatchAssembler``
:62-176).

The library is built from the port's own copy of the source by
``ops/kernels/_build.load_host`` (g++) at first use. Unlike the JAX
binding, which returns None and lets the caller assemble in Python, this
one raises when the library cannot be built or loaded.

Index and style draws stay in Python (the reference's RNG semantics,
model/train.py:88-91); worker threads copy the rows into a ring of slots,
and ``next`` hands out zero-copy NumPy views of the next submitted batch's
slot, valid until ``release``. Batches come out in submission order (the
JAX copy hands out whichever slot finished first, so with two threads its
order can change from run to run). The native path draws a whole epoch's plan up front, in
its own order (``epoch_batches``: per batch idx, then cond_idx, then style),
so its batches differ from ``ChunkDataset.epoch_batches``' for one seed.

``pin_memory=True`` page-locks each slot's buffers (``cudaHostRegister``)
the first time the slot is handed out, so a non-blocking copy to the card
reads them in place; the caller must then keep a slot until that copy has
run (``train/loop.py`` waits on an event before it releases the slot).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator

import numpy as np

_FP = ctypes.POINTER(ctypes.c_float)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The assembler library, built at first use, with its C signatures bound."""
    from ..ops.kernels import _build

    lib = _build.load_host("fastloader")
    lib.fl_create.restype = ctypes.c_void_p
    lib.fl_create.argtypes = [_FP, _FP, ctypes.POINTER(_FP), ctypes.c_int,
                              ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fl_submit.restype = ctypes.c_int
    lib.fl_submit.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(_FP)] * 4
    lib.fl_release.restype = None
    lib.fl_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fl_destroy.restype = None
    lib.fl_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeBatchAssembler:
    """Slot-ring batch assembly over a ``ChunkDataset``'s in-RAM arrays."""

    def __init__(self, dataset, batch_size: int, n_slots: int = 3, n_threads: int = 2,
                 pin_memory: bool = False):
        self._handle = None
        self._lib = _lib()
        self.ds = dataset
        self.batch = batch_size
        self.pin_memory = pin_memory
        self._pinned: dict[int, list[int]] = {}  # slot -> its registered buffer addresses
        t, p = dataset.pianoroll.shape[1:]
        tb, bins = dataset.specs[dataset.styles[0]].shape[1:]
        arrays = [dataset.pianoroll, dataset.onoff] + [dataset.specs[s] for s in dataset.styles]
        for a in arrays:
            if a.dtype != np.float32 or not a.flags.c_contiguous:
                raise ValueError("the native assembler reads C-contiguous float32 arrays")
        self._arrays = arrays  # the library borrows their memory
        self._shapes = {"roll": (batch_size, t, p), "spec": (batch_size, tb, bins)}
        specs = (_FP * len(dataset.styles))(
            *[dataset.specs[s].ctypes.data_as(_FP) for s in dataset.styles])
        self._handle = self._lib.fl_create(
            dataset.pianoroll.ctypes.data_as(_FP), dataset.onoff.ctypes.data_as(_FP),
            specs, len(dataset.styles), dataset.n_data, t * p, tb * bins,
            batch_size, n_slots, n_threads)
        if not self._handle:
            raise RuntimeError("fl_create failed")

    def submit(self, idx: np.ndarray, cond_idx: np.ndarray, style: np.ndarray) -> None:
        """Queue one batch's rows; raises ValueError on a wrong length or an
        index out of range."""
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        cond_idx = np.ascontiguousarray(cond_idx, dtype=np.int64)
        style = np.ascontiguousarray(style, dtype=np.int32)
        if not len(idx) == len(cond_idx) == len(style):
            raise ValueError("idx, cond_idx and style differ in length")
        rc = self._lib.fl_submit(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cond_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            style.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(idx))
        if rc != 0:
            raise ValueError(f"fl_submit failed: {rc}")

    def next(self) -> tuple[int, Dict[str, np.ndarray]]:
        """Wait for the next finished slot: (slot, batch of views into it)."""
        ptrs = [_FP() for _ in range(4)]
        slot = self._lib.fl_next(self._handle, *[ctypes.byref(p) for p in ptrs])
        shapes = (self._shapes["roll"], self._shapes["roll"],
                  self._shapes["spec"], self._shapes["spec"])
        if self.pin_memory and slot not in self._pinned:
            self._pinned[slot] = [_register(ctypes.cast(p, ctypes.c_void_p).value,
                                             4 * int(np.prod(sh)))
                                  for p, sh in zip(ptrs, shapes)]
        views = [np.ctypeslib.as_array(p, shape=(int(np.prod(sh)),)).reshape(sh)
                 for p, sh in zip(ptrs, shapes)]
        batch = dict(zip(("midi", "onoff", "cond", "target"), views))
        batch["weight"] = np.ones((self.batch,), np.float32)
        return slot, batch

    def release(self, slot: int) -> None:
        self._lib.fl_release(self._handle, slot)

    def close(self) -> None:
        if self._handle:
            for addrs in self._pinned.values():
                for a in addrs:
                    _unregister(a)
            self._pinned.clear()
            self._lib.fl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def epoch_batches(self, shuffle: bool = True,
                      pipeline_depth: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of full batches; each yielded batch's slot is released
        when the generator resumes, so the caller must be done with it (and
        with any copy out of it) by then."""
        ds, b = self.ds, self.batch
        order = ds.rng.permutation(ds.n_data) if shuffle else np.arange(ds.n_data)
        n_full = ds.n_data // b
        plans = []
        for k in range(n_full):
            idx = order[k * b:(k + 1) * b]
            plans.append((idx, ds.rng.integers(0, ds.n_data, b),
                          ds.rng.integers(0, len(ds.styles), b)))
        submitted = consumed = 0
        for k in range(min(pipeline_depth, n_full)):
            self.submit(*plans[k])
            submitted += 1
        slot = None
        try:
            for _ in range(n_full):
                slot, batch = self.next()
                consumed += 1
                if submitted < n_full:
                    self.submit(*plans[submitted])
                    submitted += 1
                yield batch
                self.release(slot)
                slot = None
        finally:
            # an early exit returns the yielded slot and drains what is in
            # flight, so the cached assembler's ring is whole for the next epoch
            if slot is not None:
                self.release(slot)
            while consumed < submitted:
                s, _ = self.next()
                consumed += 1
                self.release(s)


def _register(addr: int, nbytes: int) -> int:
    """Page-lock ``nbytes`` of host memory at ``addr`` for the card's copies."""
    import torch

    err = torch.cuda.cudart().cudaHostRegister(addr, nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of a loader slot failed: cudaError {int(err)}")
    return addr


def _unregister(addr: int) -> None:
    import torch

    err = torch.cuda.cudart().cudaHostUnregister(addr)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostUnregister of a loader slot failed: cudaError {int(err)}")
