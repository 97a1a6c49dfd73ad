"""The orbax checkpoint layout (``checkpoint-{epoch}.orbax``), read and
written without orbax, tensorstore or JAX.

What orbax's ``StandardCheckpointHandler`` writes (the JAX package's
``save_checkpoint_sharded``) is a directory of:
  - ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path to its
    keys (``key_type`` 1 a sequence index, 2 a dict key or a named tuple's
    field) and its ``value_type``: ``jax.Array`` or ``np.ndarray`` (a zarr
    array), ``scalar`` (a Python number, a 0-d zarr array), or ``None``
    (optax's ``EmptyState``), ``Dict``, ``List``, ``Tuple`` (an empty node:
    no data, only this entry). It also says ``"use_ocdbt": true`` and
    ``"use_zarr3": false``, the only layout read here;
  - ``_CHECKPOINT_METADATA``, ``_sharding`` and
    ``array_metadatas/process_{i}``: JSON;
  - OCDBT key-value stores (``train/ocdbt.py``) holding zarr v2 arrays:
    each process writes its chunks into its own database
    ``ocdbt.process_{i}/``, and the root database's B-tree points into
    them. For the leaf at ``('params', 'a', 'kernel')`` the key
    ``params.a.kernel/.zarray`` (its JSON: shape, chunks, dtype such as
    ``<f4``, ``<i4``, ``<i8`` or ``bfloat16``, the zstd compressor) and one
    key per chunk, ``params.a.kernel/0.0``, ``.../1.0``, ... (a 0-d array's
    chunk is ``.../0``), each value one zstd frame. An array sharded over
    devices is written as a grid of chunks of the shard's shape, each by
    the one process that holds the shard's first replica.

``read`` returns the tree that ``train/flax_msgpack.load`` returns for the
msgpack the JAX package writes of the same state: nested dicts in the JAX
layout (a sequence's elements keyed "0", "1", ...), CPU tensors, Python
scalars. An empty node is ``{}``, as in flax's state dicts (a ``None`` leaf
too). ``keys=`` reads only those top-level trees: no other tree's chunk is
read; ``regions=`` reads a leaf as a box of it, from the chunks that meet
the box and no other (a rank's slice, whatever the writer's grid). Chunks
are read and decoded in a thread pool, each straight into its place in the
destination tensor where that place is contiguous. A missing chunk, a
corrupt frame, an unknown dtype or compressor, or ``use_zarr3`` raises
``ValueError``; nothing is returned then.

Writing is a step per rank and a commit. ``write_shards(tmp, rank, tree)``
writes the blocks that ``rank`` holds (``Shard``s: a block, its place in
the whole array, and whether this rank writes it; leaves that are not
``Shard``s are whole and written by rank 0) as the chunks of its own
``ocdbt.process_{rank}/``, each chunk inside its block (``chunking`` of the
block's shape, so no two ranks write one chunk), and returns the keys it
wrote; ``commit`` takes every rank's keys and writes the ``.zarray``s, the
root database, ``_METADATA`` (``layout``: the tree's structure as orbax
records it of the JAX ``Trainer``'s state, sequences as tuples or lists,
``EmptyState`` as ``None``; every array as ``jax.Array``) and
``_CHECKPOINT_METADATA``, then renames the temporary directory, as orbax
commits. ``write`` is both for one process. No ``_sharding`` is written:
the JAX package's host restore then reads each array as a host array, and
a restore into a template takes the template's shardings.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
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
DICT_KEY = 2  # orbax's key_type of a dict key or a named tuple's field
SEQUENCE_INDEX = 1  # orbax's key_type of a tuple's or a list's index

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
    """One zarr array being read, whole or the box ``region`` ((offset,
    size)) of it: its destination and the jobs of the chunks that meet
    the box."""

    def __init__(self, path, name, index, db, region=None):
        key = f"{name}/.zarray".encode()
        if key not in index:
            raise ValueError(f"{path}: {name}/.zarray is missing")
        self.shape, self.chunks, self.dtype, sep = _zarray(
            path, name, db.read(index[key]))
        if len(self.chunks) != len(self.shape):
            raise ValueError(f"{path}: {name} has chunks {list(self.chunks)} for shape "
                             f"{list(self.shape)}")
        self.lo, size = region or ((0,) * len(self.shape), self.shape)
        if len(self.lo) != len(self.shape) or any(
                o < 0 or n < 0 or o + n > s for o, n, s in zip(self.lo, size, self.shape)):
            raise ValueError(f"{path}: the box {list(self.lo)} + {list(size)} is not inside "
                             f"{name} of shape {list(self.shape)}")
        self.out = torch.empty(tuple(size), dtype=self.dtype)
        self.jobs = []
        if self.out.numel() == 0:
            return
        ranges = [range(o // c, -(-(o + n) // c)) for o, n, c in zip(self.lo, size, self.chunks)]
        for g in itertools.product(*ranges):
            ckey = f"{name}/{sep.join(map(str, g)) if g else '0'}".encode()
            if ckey not in index:
                raise ValueError(f"{path}: chunk {ckey.decode()} of {name} is missing")
            self.jobs.append((g, index[ckey]))

    def _place(self, rel: list) -> torch.Tensor | None:
        """The chunk at ``rel`` (relative to the box) as a view of ``out``
        where that is contiguous: inside the box, one index on the axes
        before some axis ``j``, the whole extent on the axes after it.
        Else None."""
        shape = tuple(self.out.shape)
        if any(a < 0 or a + c > s for a, c, s in zip(rel, self.chunks, shape)):
            return None
        if not shape:
            return self.out
        for j in range(len(shape)):
            if (all(c == 1 for c in self.chunks[:j])
                    and tuple(self.chunks[j + 1:]) == shape[j + 1:]):
                return self.out[tuple(rel[:j]) + (slice(rel[j], rel[j] + self.chunks[j]),)]
        return None

    def fill(self, db, g: tuple, value, what: str) -> None:
        """Read and decode chunk ``g`` into its place in ``out``."""
        frame = db.read(value)
        lo = [i * c for i, c in zip(g, self.chunks)]
        dst = self._place([a - o for a, o in zip(lo, self.lo)])
        direct = dst is not None
        if not direct:
            dst = torch.empty(self.chunks, dtype=self.dtype)
        try:
            zstd.decompress_into(frame, dst.data_ptr(), dst.numel() * dst.element_size())
        except ValueError as e:
            raise ValueError(f"{what}: {e}") from None
        if not direct:
            # the part of the chunk inside both the array and the box
            a = [max(x, o) for x, o in zip(lo, self.lo)]
            b = [min(x + c, o + n) for x, c, o, n in zip(lo, self.chunks, self.lo,
                                                         self.out.shape)]
            self.out[tuple(slice(i - o, j - o) for i, j, o in zip(a, b, self.lo))] = \
                dst[tuple(slice(i - x, j - x) for i, j, x in zip(a, b, lo))]


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


def read(path: str, keys: Iterable[str] | None = None, stats: dict | None = None,
         regions: dict | None = None) -> dict:
    """The checkpoint's tree (only the top-level ``keys`` where given; a key
    it lacks is left out). ``regions`` maps a leaf's key path (a tuple) to
    a box (offset, size): that leaf is read as the box alone, from the
    chunks that meet it and no other (a path the checkpoint lacks raises
    ``ValueError``). ``stats``, where given, receives the bytes read:
    ``value_bytes`` (chunks and ``.zarray``s), ``node_bytes`` (the store's
    manifest and nodes) and ``chunks``."""
    md = _metadata(path)
    wanted = None if keys is None else set(keys)
    leaves = [(k, t) for k, t in _leaves(md) if wanted is None or k[0] in wanted]
    regions = {tuple(k): v for k, v in (regions or {}).items()}
    missing = set(regions) - {k for k, _ in leaves}
    if missing:
        raise ValueError(f"{path} lacks {sorted('.'.join(k) for k in missing)}")
    tree: dict = {}
    with ocdbt.Database(path) as db:
        index = _index(db, None if wanted is None else sorted({k[0] for k, _ in leaves}))
        arrays = []
        for keys_, vtype in leaves:
            name = ".".join(keys_)
            if vtype in EMPTY_TYPES:
                _insert(tree, keys_, {})
            elif vtype in ARRAY_TYPES or vtype == "scalar":
                arr = _Array(path, name, index, db, regions.get(keys_))
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

@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's block of an array: ``data`` (None where only its place
    is needed) lies at ``offset`` in an array of ``shape`` and ``dtype``,
    and has the shape ``size``. Of the ranks that hold one block, the one
    with ``write`` writes it."""
    data: torch.Tensor | None
    shape: tuple
    offset: tuple
    size: tuple
    dtype: torch.dtype
    write: bool

    def permute(self, dims) -> "Shard":
        """This block of the array permuted to ``dims`` (None: unchanged)."""
        if dims is None:
            return self
        p = lambda t: tuple(t[d] for d in dims)  # noqa: E731
        return Shard(None if self.data is None else self.data.permute(dims), p(self.shape),
                     p(self.offset), p(self.size), self.dtype, self.write)


_EMPTY = {type(None): "None", dict: "Dict", list: "List", tuple: "Tuple"}


def _flatten(tree, path=(), types=()) -> list[tuple[tuple[str, ...], tuple[int, ...], Any]]:
    """(keys, key types, leaf) of every leaf and empty node: dict keys
    (sorted, as JAX flattens a dict) have key type 2, sequence indices 1."""
    if isinstance(tree, dict) and tree:
        items = []
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(f"orbax trees have string keys, not {k!r}")
            items.append((k, DICT_KEY, tree[k]))
    elif isinstance(tree, (tuple, list)) and tree:
        items = [(str(i), SEQUENCE_INDEX, v) for i, v in enumerate(tree)]
    else:
        return [(path, types, tree)]
    out = []
    for k, kt, v in items:
        out += _flatten(v, path + (k,), types + (kt,))
    return out


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):  # a view on the card is made whole there
        return v.detach().contiguous().cpu()
    return torch.from_numpy(np.array(v, order="C"))


def _largest_divisor(n: int, cap: int) -> int:
    best, d = 1, 1
    while d * d <= n:
        if n % d == 0:
            best = max([best] + [x for x in (d, n // d) if x <= cap])
        d += 1
    return best


def chunking(shape: tuple, itemsize: int, limit: int) -> tuple:
    """The chunk shape the writer gives a block of ``shape`` (a shard, or a
    whole array): the whole block where it is at most ``limit`` bytes;
    else one index on the leading axes, the whole extent on the trailing
    ones and, on the axis between, the largest divisor of its extent that
    keeps a chunk within ``limit`` (at least 1). Every chunk then lies
    inside the block (no edge chunk) and is contiguous in it."""
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


def _zarray_json(shape: tuple, dtype: torch.dtype, chunks: tuple) -> bytes:
    if dtype not in _NAMES:
        raise TypeError(f"dtype {dtype} cannot be written to an orbax checkpoint")
    return json.dumps({"chunks": list(chunks), "compressor": {"id": "zstd", "level": zstd.LEVEL},
                       "dimension_separator": ".", "dtype": _NAMES[dtype],
                       "fill_value": None, "filters": None, "order": "C",
                       "shape": list(shape), "zarr_format": 2},
                      sort_keys=True, separators=(",", ":")).encode()


def _scalar(v) -> torch.Tensor:
    if isinstance(v, bool):
        return torch.tensor(v, dtype=torch.bool)
    return torch.tensor(v, dtype=torch.int64 if isinstance(v, int) else torch.float64)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One entry of the tree's metadata; ``name``, ``shape``, ``dtype`` and
    ``chunks`` for an array (every rank's blocks of it are chunked alike)."""
    keys: tuple
    key_types: tuple
    value_type: str
    name: str | None = None
    shape: tuple = ()
    dtype: torch.dtype | None = None
    chunks: tuple = ()


def _block(v) -> Shard | None:
    """An array leaf as a block: a ``Shard`` as it is; a tensor, array or
    Python scalar as the whole, written by the coordinator (rank 0)."""
    if isinstance(v, Shard):
        return v
    if isinstance(v, (bool, int, float)):
        v = _scalar(v)
    elif isinstance(v, np.ndarray):
        v = _as_tensor(v)
    elif not isinstance(v, torch.Tensor):
        return None
    return Shard(v, tuple(v.shape), (0,) * v.dim(), tuple(v.shape), v.dtype, True)


def shards(tree, keys=()) -> dict[tuple, Shard]:
    """{key path: block} of the ``Shard`` leaves of a JAX-layout tree (dict
    keys and sequence indices as strings)."""
    if isinstance(tree, Shard):
        return {keys: tree}
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (tuple, list)) else ())
    out = {}
    for k, v in items:
        out.update(shards(v, keys + (str(k),)))
    return out


def layout(tree) -> list[Leaf]:
    """The metadata of ``tree`` (nested dicts, tuples and lists in the JAX
    layout; tensors, numpy arrays, ``Shard``s and Python scalars; ``None``
    and empty nodes): every array as ``jax.Array``, every Python number as
    ``scalar``, as orbax records the JAX ``Trainer``'s state."""
    out = []
    for keys, types, v in _flatten(tree):
        name = ".".join(keys)
        if type(v) in _EMPTY and not v:
            out.append(Leaf(keys, types, _EMPTY[type(v)]))
            continue
        b = _block(v)
        if b is None:
            raise TypeError(f"cannot write {type(v).__name__} at {name} to an orbax checkpoint")
        itemsize = torch.empty((), dtype=b.dtype).element_size()
        out.append(Leaf(keys, types, "scalar" if isinstance(v, (bool, int, float)) else
                        "jax.Array", name, b.shape, b.dtype, chunking(b.size, itemsize, CHUNK_BYTES)))
    return out


def process_dir(rank: int) -> str:
    return f"ocdbt.process_{rank}"


def write_shards(tmp: str, rank: int, tree) -> dict:
    """One rank's step of a write into the checkpoint's temporary directory
    ``tmp``: the chunks of the blocks this rank writes (``Shard``s with
    ``write``, and, for rank 0, the leaves that are not ``Shard``s) as its
    own database ``ocdbt.process_{rank}/``, and ``array_metadatas/process_
    {rank}``. The chunks lie inside the block (``chunking`` of its shape),
    keyed by their place in the whole array. Returns the database's
    entries (``ocdbt.Writer.commit``) for ``commit``."""
    db = ocdbt.Writer(os.path.join(tmp, process_dir(rank)))
    metas = []
    with concurrent.futures.ThreadPoolExecutor(_workers()) as pool:
        # compress in the pool, at most two chunks per worker ahead of the
        # writes to the data files
        pending: list = []
        for keys, _, v in _flatten(tree):
            b = _block(v)
            if b is None or not b.write or (rank and not isinstance(v, Shard)):
                continue
            t = _as_tensor(b.data)
            chunks = chunking(b.size, t.element_size(), CHUNK_BYTES)
            name = ".".join(keys)
            metas.append({"array_metadata": {"param_name": name, "write_shape": list(b.size),
                                             "chunk_shape": list(chunks), "ext_metadata": None}})
            grid = [s // c if c else 0 for s, c in zip(b.size, chunks)]
            for g in np.ndindex(*grid) if t.numel() else []:
                at = [o // c + i for o, c, i in zip(b.offset, chunks, g)]
                key = f"{name}/{'.'.join(map(str, at)) if at else '0'}".encode()
                part = t[tuple(slice(i * c, (i + 1) * c) for i, c in zip(g, chunks))]
                pending.append((key, pool.submit(zstd.compress, part)))
                while len(pending) > 2 * _workers():
                    k, f = pending.pop(0)
                    db.put(k, f.result())
        for k, f in pending:
            db.put(k, f.result())
    entries = db.commit()
    os.makedirs(os.path.join(tmp, "array_metadatas"), exist_ok=True)
    _json(tmp, os.path.join("array_metadatas", f"process_{rank}"), {"array_metadatas": metas})
    return entries


def commit(tmp: str, path: str, leaves: list[Leaf], entries: list[dict],
           t0: int | None = None) -> str:
    """The coordinator's commit of a write whose ranks (``entries[r]``: rank
    r's ``write_shards``) have all written into ``tmp``: the ``.zarray``s
    and every rank's chunks in the root database (its B-tree points into
    each ``ocdbt.process_{r}/``), ``_METADATA`` of ``leaves``
    (``layout``) and ``_CHECKPOINT_METADATA``; then ``tmp`` is
    renamed to ``path`` (replacing a checkpoint there). A chunk written
    twice, or by no rank, raises ``ValueError`` and nothing is committed."""
    root = ocdbt.Writer(tmp)
    for r, ents in enumerate(entries):
        for k, v in ents.items():
            if isinstance(v, bytes):
                root.put(k, v)
            else:
                root.put_ref(k, process_dir(r) + "/", *v)
    tree_md = {}
    for leaf in leaves:
        if leaf.name is None:
            vmeta = {"value_type": leaf.value_type, "skip_deserialize": True}
        else:
            vmeta = {"value_type": leaf.value_type, "skip_deserialize": False}
            if leaf.value_type == "jax.Array":
                vmeta["write_shape"] = list(leaf.chunks)
            root.put(f"{leaf.name}/.zarray".encode(),
                     _zarray_json(leaf.shape, leaf.dtype, leaf.chunks))
            grid = [s // c if c else 0 for s, c in zip(leaf.shape, leaf.chunks)]
            for g in np.ndindex(*grid) if math.prod(leaf.shape) else []:
                key = f"{leaf.name}/{'.'.join(map(str, g)) if g else '0'}".encode()
                if key not in root.entries:
                    raise ValueError(f"{path}: chunk {key.decode()} was written by no rank")
        tree_md[repr(leaf.keys)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in zip(leaf.keys, leaf.key_types)],
            "value_metadata": vmeta}
    root.commit()
    _json(tmp, METADATA, {"tree_metadata": tree_md, "use_ocdbt": True, "use_zarr3": False,
                          "store_array_data_equal_to_fill_value": True,
                          "custom_metadata": None})
    _json(tmp, CHECKPOINT_METADATA, {
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": time.time_ns() if t0 is None else t0,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def write(path: str, tree) -> str:
    """Write ``tree`` (see ``layout``; whole leaves) as an orbax checkpoint
    at ``path`` (replacing one there), as one process: ``write_shards`` of
    rank 0 into ``{path}.tmp``, each file synced, then ``commit``."""
    tmp = f"{path}.tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    t0 = time.time_ns()
    leaves = layout(tree)
    return commit(tmp, path, leaves, [write_shards(tmp, 0, tree)], t0)


def _json(root: str, name: str, obj) -> None:
    with open(os.path.join(root, name), "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
