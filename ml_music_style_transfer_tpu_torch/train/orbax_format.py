"""The orbax checkpoint layout (``checkpoint-{epoch}.orbax``), read and
written without orbax, tensorstore or JAX.

What orbax's ``StandardCheckpointHandler`` writes (the JAX package's
``save_checkpoint_sharded``) is a directory of:
  - ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path to its
    keys (``key_type`` 1 a sequence index, 2 a dict key or field) and its
    ``value_type``: ``jax.Array`` or ``np.ndarray`` (a zarr array),
    ``scalar`` (a Python number, a 0-d zarr array), or ``None``, ``Dict``,
    ``List``, ``Tuple`` (an empty node: no data, only this entry). It
    also says ``"use_ocdbt": true`` and ``"use_zarr3": false``, the only
    layout read here;
  - ``_CHECKPOINT_METADATA``, ``_sharding`` and
    ``array_metadatas/process_0``: JSON;
  - one OCDBT key-value store (``train/ocdbt.py``) holding zarr v2 arrays:
    for the leaf at ``('params', 'a', 'kernel')`` the key
    ``params.a.kernel/.zarray`` (its JSON: shape, chunks, dtype such as
    ``<f4``, ``<i4``, ``<i8`` or ``bfloat16``, the zstd compressor) and one
    key per chunk, ``params.a.kernel/0.0``, ``.../1.0``, ... (a 0-d array's
    chunk is ``.../0``), each value one zstd frame. An array sharded over
    devices is written as a grid of chunks of the shard's shape.

``read`` returns the tree that ``train/flax_msgpack.load`` returns for the
msgpack the JAX package writes of the same state: nested dicts in the JAX
layout (a sequence's elements keyed "0", "1", ...), CPU tensors, Python
scalars. An empty node is ``{}``, as in flax's state dicts: orbax writes
optax's field-less states (``EmptyState``) as ``None``, so a ``None`` leaf
is read as ``{}`` too. ``keys=`` reads only those top-level trees: no
other tree's chunk is read. Chunks are read and decoded in a thread pool,
each straight into its place in the destination tensor where that place
is contiguous. A missing chunk, a corrupt frame, an unknown dtype or
compressor, or ``use_zarr3`` raises ``ValueError``; nothing is returned
then.

``write`` writes a tree in the JAX layout (nested dicts with string keys;
tensors, numpy arrays, Python scalars, ``None`` and empty dicts) in that
form, every array as ``np.ndarray`` in chunks of at most ``CHUNK_BYTES``
(``chunking``: each contiguous in the array, so that they compress and
decode in parallel), through a temporary directory that is renamed on
commit, as orbax does.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import shutil
import time
from typing import Any, Iterable

import numpy as np
import torch

from . import ocdbt, zstd

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
ARRAY_TYPES = ("jax.Array", "np.ndarray")
EMPTY_TYPES = ("None", "Dict", "List", "Tuple")
CHUNK_BYTES = 32 << 20  # the writer's chunks: enough of them to decode in parallel
DICT_KEY = 2  # orbax's key_type of a dict key (1: a sequence index)

_DTYPES = {"<f4": torch.float32, "<f8": torch.float64, "<f2": torch.float16,
           "bfloat16": torch.bfloat16, "<i8": torch.int64, "<i4": torch.int32,
           "|b1": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _workers() -> int:
    return min(16, os.cpu_count() or 1)


# ---- reading ----------------------------------------------------------------

def _metadata(path: str) -> dict:
    f = os.path.join(path, METADATA)
    if not os.path.isfile(f):
        raise FileNotFoundError(f"{path} has no {METADATA}: not an orbax checkpoint")
    with open(f) as fh:
        md = json.load(fh)
    if md.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3: true (zarr v3 arrays) is not supported")
    if not md.get("use_ocdbt"):
        raise ValueError(f"{path}: use_ocdbt: false (one zarr directory per array) is "
                         "not supported")
    return md


def _leaves(md: dict) -> list[tuple[tuple[str, ...], str]]:
    out = []
    for entry in md["tree_metadata"].values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        out.append((keys, entry["value_metadata"]["value_type"]))
    return out


def _zarray(path: str, name: str, raw: bytes) -> tuple[tuple, tuple, torch.dtype, str]:
    z = json.loads(raw)
    if z.get("zarr_format") != 2:
        raise ValueError(f"{path}: {name} is zarr format {z.get('zarr_format')}, not 2")
    dtype = _DTYPES.get(z["dtype"])
    if dtype is None:
        raise ValueError(f"{path}: {name} has dtype {z['dtype']!r}, which is not supported")
    comp = z.get("compressor") or {}
    if comp.get("id") != "zstd":
        raise ValueError(f"{path}: {name} has compressor {comp.get('id')!r}; only zstd "
                         "is supported")
    if z.get("order", "C") != "C" or z.get("filters"):
        raise ValueError(f"{path}: {name} has order {z.get('order')!r} and filters "
                         f"{z.get('filters')!r}; only C order with no filters is supported")
    return tuple(z["shape"]), tuple(z["chunks"]), dtype, z.get("dimension_separator", ".")


class _Array:
    """One zarr array being read: its destination and its chunks' jobs."""

    def __init__(self, path, name, index, db):
        key = f"{name}/.zarray".encode()
        if key not in index:
            raise ValueError(f"{path}: {name}/.zarray is missing")
        self.shape, self.chunks, self.dtype, sep = _zarray(
            path, name, db.read(index[key]))
        if len(self.chunks) != len(self.shape):
            raise ValueError(f"{path}: {name} has chunks {list(self.chunks)} for shape "
                             f"{list(self.shape)}")
        self.out = torch.empty(self.shape, dtype=self.dtype)
        grid = [math.ceil(s / c) if c else 0 for s, c in zip(self.shape, self.chunks)]
        self.jobs = []
        if self.out.numel() == 0:
            return
        for g in np.ndindex(*grid) if grid else [()]:
            ckey = f"{name}/{sep.join(map(str, g)) if g else '0'}".encode()
            if ckey not in index:
                raise ValueError(f"{path}: chunk {ckey.decode()} of {name} is missing")
            self.jobs.append((g, index[ckey]))

    def _place(self, lo: list) -> torch.Tensor | None:
        """The chunk at ``lo`` as a view of ``out`` where that is contiguous:
        inside the array, one index on the axes before some axis ``j``, the
        whole extent on the axes after it. Else None."""
        if any(a + c > s for a, c, s in zip(lo, self.chunks, self.shape)):
            return None
        if not self.shape:
            return self.out
        for j in range(len(self.shape)):
            if (all(c == 1 for c in self.chunks[:j])
                    and tuple(self.chunks[j + 1:]) == tuple(self.shape[j + 1:])):
                return self.out[tuple(lo[:j]) + (slice(lo[j], lo[j] + self.chunks[j]),)]
        return None

    def fill(self, db, g: tuple, value, what: str) -> None:
        """Read and decode chunk ``g`` into its place in ``out``."""
        frame = db.read(value)
        lo = [i * c for i, c in zip(g, self.chunks)]
        dst = self._place(lo)
        direct = dst is not None
        if not direct:
            dst = torch.empty(self.chunks, dtype=self.dtype)
        try:
            zstd.decompress_into(frame, dst.data_ptr(), dst.numel() * dst.element_size())
        except ValueError as e:
            raise ValueError(f"{what}: {e}") from None
        if not direct:
            region = tuple(slice(a, min(a + c, s)) for a, c, s in
                           zip(lo, self.chunks, self.shape))
            self.out[region] = dst[tuple(slice(0, r.stop - r.start) for r in region)]


def _index(db: ocdbt.Database, tops: Iterable[str] | None) -> dict:
    """key -> value of the store's keys under the top-level trees ``tops``
    (all where None)."""
    if tops is None:
        return dict(db.items())
    index = {}
    for top in tops:
        t = top.encode()
        index.update((k, v) for k, v in db.items(t) if k[len(t):len(t) + 1] in (b".", b"/"))
    return index


def _insert(tree: dict, keys: tuple, value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def read(path: str, keys: Iterable[str] | None = None, stats: dict | None = None) -> dict:
    """The checkpoint's tree (only the top-level ``keys`` where given; a key
    it lacks is left out). ``stats``, where given, receives the bytes read:
    ``value_bytes`` (chunks and ``.zarray``s), ``node_bytes`` (the store's
    manifest and nodes) and ``chunks``."""
    md = _metadata(path)
    wanted = None if keys is None else set(keys)
    leaves = [(k, t) for k, t in _leaves(md) if wanted is None or k[0] in wanted]
    tree: dict = {}
    with ocdbt.Database(path) as db:
        index = _index(db, None if wanted is None else sorted({k[0] for k, _ in leaves}))
        arrays = []
        for keys_, vtype in leaves:
            name = ".".join(keys_)
            if vtype in EMPTY_TYPES:
                _insert(tree, keys_, {})
            elif vtype in ARRAY_TYPES or vtype == "scalar":
                arr = _Array(path, name, index, db)
                arrays.append((keys_, vtype, arr))
            else:
                raise ValueError(f"{path}: {name} has value_type {vtype!r}, which is not "
                                 "supported")
        jobs = [(arr, g, v, f"{path}: {'.'.join(k)} chunk {g}")
                for k, _, arr in arrays for g, v in arr.jobs]
        with concurrent.futures.ThreadPoolExecutor(_workers()) as pool:
            for f in [pool.submit(arr.fill, db, g, v, what) for arr, g, v, what in jobs]:
                f.result()
        for keys_, vtype, arr in arrays:
            _insert(tree, keys_, arr.out.item() if vtype == "scalar" else arr.out)
        if stats is not None:
            stats.update(value_bytes=db.value_bytes, node_bytes=db.node_bytes,
                         chunks=len(jobs))
    return tree


# ---- writing ----------------------------------------------------------------

def _flatten(tree: dict, path=()) -> list[tuple[tuple[str, ...], Any]]:
    out = []
    for k in sorted(tree):
        if not isinstance(k, str):
            raise TypeError(f"orbax trees have string keys, not {k!r}")
        v = tree[k]
        if isinstance(v, dict) and v:
            out += _flatten(v, path + (k,))
        else:
            out.append((path + (k,), v))
    return out


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().contiguous()
    return torch.from_numpy(np.array(v, order="C"))


def _largest_divisor(n: int, cap: int) -> int:
    best, d = 1, 1
    while d * d <= n:
        if n % d == 0:
            best = max([best] + [x for x in (d, n // d) if x <= cap])
        d += 1
    return best


def chunking(shape: tuple, itemsize: int, limit: int) -> tuple:
    """The chunk shape the writer gives an array: the whole array where it
    is at most ``limit`` bytes; else one index on the leading axes, the
    whole extent on the trailing ones and, on the axis between, the
    largest divisor of its extent that keeps a chunk within ``limit`` (at
    least 1). Every chunk is then whole (no edge chunk) and contiguous in
    the array."""
    chunks = list(shape)
    for j, n in enumerate(shape):
        rest = itemsize * math.prod(shape[j + 1:])
        if rest * n <= limit:
            break
        if rest <= limit:
            chunks[j] = _largest_divisor(n, limit // rest)
            break
        chunks[j] = 1
    return tuple(chunks)


def _zarray_json(t: torch.Tensor, chunks: tuple) -> bytes:
    if t.dtype not in _NAMES:
        raise TypeError(f"dtype {t.dtype} cannot be written to an orbax checkpoint")
    return json.dumps({"chunks": list(chunks), "compressor": {"id": "zstd", "level": zstd.LEVEL},
                       "dimension_separator": ".", "dtype": _NAMES[t.dtype],
                       "fill_value": None, "filters": None, "order": "C",
                       "shape": list(t.shape), "zarr_format": 2},
                      sort_keys=True, separators=(",", ":")).encode()


def _scalar(v) -> torch.Tensor:
    if isinstance(v, bool):
        return torch.tensor(v, dtype=torch.bool)
    return torch.tensor(v, dtype=torch.int64 if isinstance(v, int) else torch.float64)


def write(path: str, tree: dict) -> str:
    """Write ``tree`` as an orbax checkpoint at ``path`` (replacing one
    there): into ``{path}.tmp``, each file synced, then renamed."""
    tmp = f"{path}.tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    t0 = time.time_ns()
    tree_md, arrays = {}, []
    for keys, v in _flatten(tree):
        if isinstance(v, dict) or v is None:
            vmeta = {"value_type": "Dict" if isinstance(v, dict) else "None",
                     "skip_deserialize": True}
        elif isinstance(v, (bool, int, float)):
            vmeta = {"value_type": "scalar", "skip_deserialize": False}
            arrays.append((".".join(keys), _scalar(v)))
        elif isinstance(v, (torch.Tensor, np.ndarray)):
            vmeta = {"value_type": "np.ndarray", "skip_deserialize": False}
            arrays.append((".".join(keys), _as_tensor(v)))
        else:
            raise TypeError(f"cannot write {type(v).__name__} at {'.'.join(keys)} to an "
                            "orbax checkpoint")
        tree_md[repr(keys)] = {"key_metadata": [{"key": k, "key_type": DICT_KEY} for k in keys],
                               "value_metadata": vmeta}
    db = ocdbt.Writer(tmp)
    with concurrent.futures.ThreadPoolExecutor(_workers()) as pool:
        # compress in the pool, at most two chunks per worker ahead of the
        # writes to the data files
        pending: list = []
        for name, t in arrays:
            chunks = chunking(tuple(t.shape), t.element_size(), CHUNK_BYTES)
            db.put(f"{name}/.zarray".encode(), _zarray_json(t, chunks))
            grid = [s // c if c else 0 for s, c in zip(t.shape, chunks)]
            for g in np.ndindex(*grid) if t.numel() else []:
                key = f"{name}/{'.'.join(map(str, g)) if g else '0'}".encode()
                part = t[tuple(slice(i * c, (i + 1) * c) for i, c in zip(g, chunks))]
                pending.append((key, pool.submit(zstd.compress, part)))
                while len(pending) > 2 * _workers():
                    k, f = pending.pop(0)
                    db.put(k, f.result())
        for k, f in pending:
            db.put(k, f.result())
    db.commit()
    _json(tmp, METADATA, {"tree_metadata": tree_md, "use_ocdbt": True, "use_zarr3": False,
                          "store_array_data_equal_to_fill_value": True,
                          "custom_metadata": None})
    _json(tmp, "_sharding", {})
    os.makedirs(os.path.join(tmp, "array_metadatas"))
    _json(tmp, os.path.join("array_metadatas", "process_0"), {"array_metadatas": []})
    _json(tmp, CHECKPOINT_METADATA, {
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}})
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def _json(root: str, name: str, obj) -> None:
    with open(os.path.join(root, name), "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
