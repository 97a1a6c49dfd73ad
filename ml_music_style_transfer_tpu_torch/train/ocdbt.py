"""A reader and writer of tensorstore's OCDBT key-value stores, in plain
Python: the store orbax writes a checkpoint's zarr keys into
(``"use_ocdbt": true``). The card's machine has neither tensorstore nor
orbax.

The format is tensorstore's ("OCDBT storage format" in its
documentation). A database directory holds ``manifest.ocdbt`` and data
files under ``d/``; orbax's root database also points into per-process
databases (``ocdbt.process_0/d/...``) by relative path. Every manifest
and B-tree node is one frame:
  - the magic, 4 bytes big-endian (``MANIFEST_MAGIC``, ``NODE_MAGIC``);
  - the frame's length, 8 bytes little-endian;
  - the format version (0) and the compression (0 none, 1 zstd), varints;
  - the payload;
  - the crc32c of all preceding bytes, 4 bytes little-endian.
The manifest holds the config, the data files its versions name, and the
newest versions, each with its B-tree root (file, offset, length, height).
A node holds its data-file table and its entries, column by column:
prefix-compressed keys, then (in a leaf) each value's length, kind and,
for an indirect value, its (file, offset); inline values follow. An
interior entry names a child node and the length of the key prefix that
the child's keys leave out.

``Database`` reads: it checks every frame (magic, length, version,
compression, crc32c) and raises ``ValueError`` naming what it found, lists
keys under a prefix (reading only the nodes whose key range meets it) and
reads an indirect value with ``os.pread`` at its offset. It counts the
bytes it reads: ``node_bytes`` for manifests and nodes, ``value_bytes``
for values. ``Writer`` writes the simplest layout tensorstore and orbax
read: one version, leaves of at most ``max_decoded_node_bytes`` under
interior nodes where there is more than one, values over
``max_inline_value_bytes`` in data files. ``commit`` hands back the
database's entries (key -> inline value, or (data file, offset, length)),
so that a root database can hold the keys of several process databases:
``put_ref`` enters a value that lies in another database's data file, by
its path relative to the root (``ocdbt.process_1/`` + ``d/...``), as
orbax's root database does.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import uuid
from typing import Iterator

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
NO_ROOT = 2**64 - 1  # offset and length of an empty version's root
# orbax's config (orbax/checkpoint/_src/serialization/ts_utils.py)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
DATA_FILE_BYTES = 1 << 30  # the writer starts a new data file past this


# ---- crc32c (Castagnoli), table-driven ------------------------------------

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data) -> int:
    c = 0xFFFFFFFF
    t = _CRC
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ---- frames and varints -----------------------------------------------------

class _In:
    """A cursor over a decoded payload; reading past its end raises."""

    def __init__(self, b: bytes, what: str):
        self.b, self.p, self.what = b, 0, what

    def raw(self, n: int) -> bytes:
        if self.p + n > len(self.b):
            raise ValueError(f"{self.what}: truncated payload")
        out = self.b[self.p:self.p + n]
        self.p += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            c = self.byte()
            v |= (c & 0x7F) << shift
            if not c & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 10 bytes")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def decode_frame(buf: bytes, magic: int, what: str) -> bytes:
    """The payload of one manifest or node frame; raises ``ValueError`` on a
    wrong magic, length, version or compression, or a crc32c mismatch."""
    if len(buf) < 4 + 8 + 2 + 4:
        raise ValueError(f"{what}: {len(buf)} bytes is too short for a frame (truncated)")
    found = struct.unpack(">I", buf[:4])[0]
    if found != magic:
        raise ValueError(f"{what}: magic 0x{found:08x} where 0x{magic:08x} is expected")
    length = struct.unpack("<Q", buf[4:12])[0]
    if length != len(buf):
        raise ValueError(f"{what}: the frame says {length} bytes but {len(buf)} were read "
                         "(truncated)")
    want = struct.unpack("<I", buf[-4:])[0]
    got = crc32c(buf[:-4])
    if got != want:
        raise ValueError(f"{what}: crc32c mismatch (stored 0x{want:08x}, computed 0x{got:08x})")
    head = _In(buf[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version} is not supported")
    compression = head.varint()
    body = buf[12 + head.p:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"{what}: unknown compression {compression}")


def encode_frame(payload: bytes, magic: int) -> bytes:
    body = _varint(0) + _varint(1) + zstd.compress(payload)
    head = struct.pack(">I", magic) + struct.pack("<Q", 4 + 8 + len(body) + 4)
    frame = head + body
    return frame + struct.pack("<I", crc32c(frame))


# ---- the structures ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataFile:
    base: str  # the part of the path a referenced node's own table is relative to
    rel: str

    @property
    def path(self) -> str:
        return self.base + self.rel


@dataclasses.dataclass(frozen=True)
class Ref:
    """An indirect value or a node: ``length`` bytes at ``offset`` of ``file``."""
    file: DataFile
    offset: int
    length: int


@dataclasses.dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: tuple[int, int]  # (0, 0) none, (1, level) zstd


def _read_config(r: _In) -> Config:
    uid = r.raw(16)
    kind = r.varint()
    max_inline, max_node = r.varint(), r.varint()
    arity = r.byte()
    method = r.varint()
    if method == 0:
        comp = (0, 0)
    elif method == 1:
        comp = (1, struct.unpack("<i", r.raw(4))[0])
    else:
        raise ValueError(f"{r.what}: unknown compression method {method} in the config")
    return Config(uid, kind, max_inline, max_node, arity, comp)


def _write_config(c: Config) -> bytes:
    out = c.uuid + _varint(c.manifest_kind) + _varint(c.max_inline_value_bytes) \
        + _varint(c.max_decoded_node_bytes) + bytes([c.version_tree_arity_log2]) \
        + _varint(c.compression[0])
    if c.compression[0] == 1:
        out += struct.pack("<i", c.compression[1])
    return out


def _read_files(r: _In, base: str) -> list[DataFile]:
    """A data-file table; each path is relative to ``base`` (the base of the
    file the node or manifest was read from)."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: data-file path prefix {prefix[i]} exceeds "
                             "the previous path")
        path = prev[:prefix[i]] + r.raw(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"{r.what}: base path longer than its path")
        p = path.decode()
        files.append(DataFile(base + p[:base_len[i]], p[base_len[i]:]))
        prev = path
    return files


def _write_files(files: list[tuple[str, str]]) -> bytes:
    """A data-file table of (base, relative path) pairs, sorted by path."""
    enc = [(b + r).encode() for b, r in files]
    prefix = [_common(a, b) for a, b in zip(enc, enc[1:])]
    out = _varint(len(enc)) + b"".join(map(_varint, prefix))
    out += b"".join(_varint(len(e) - p) for e, p in zip(enc, [0] + prefix))
    out += b"".join(_varint(len(b.encode())) for b, _ in files)
    return out + b"".join(e[p:] for e, p in zip(enc, [0] + prefix))


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _read_keys(r: _In, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: key prefix {prefix[i]} exceeds the previous key")
        key = prev[:prefix[i]] + r.raw(suffix[i])
        if interior and common[i] > len(key):
            raise ValueError(f"{r.what}: subtree prefix longer than its key")
        keys.append(key)
        prev = key
    return keys, common


def _write_keys(keys: list[bytes], interior: bool) -> bytes:
    prefix = [_common(a, b) for a, b in zip(keys, keys[1:])]
    out = b"".join(map(_varint, prefix))
    out += b"".join(_varint(len(k) - p) for k, p in zip(keys, [0] + prefix))
    if interior:
        out += b"".join(_varint(0) for _ in keys)
    return out + b"".join(k[p:] for k, p in zip(keys, [0] + prefix))


def _file_id(r: _In, files: list[DataFile]) -> DataFile:
    i = r.varint()
    if i >= len(files):
        raise ValueError(f"{r.what}: data file {i} of a table of {len(files)}")
    return files[i]


@dataclasses.dataclass
class Node:
    height: int
    keys: list[bytes]  # relative to the node's prefix
    values: list  # leaf: bytes (inline) or Ref; interior: (common prefix length, Ref)


def parse_node(payload: bytes, base: str, what: str) -> Node:
    r = _In(payload, what)
    height = r.byte()
    files = _read_files(r, base)
    n = r.varint()
    if n == 0:
        raise ValueError(f"{what}: empty B-tree node")
    keys, common = _read_keys(r, n, height > 0)
    if height > 0:
        ids = [_file_id(r, files) for _ in range(n)]
        offsets, lengths = r.varints(n), r.varints(n)
        r.varints(3 * n)  # per-child statistics
        values = [(c, Ref(f, o, ln)) for c, f, o, ln in zip(common, ids, offsets, lengths)]
    else:
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: unknown value kind {max(kinds)}")
        m = sum(kinds)
        ids = [_file_id(r, files) for _ in range(m)]
        offsets = r.varints(m)
        it = iter(zip(ids, offsets))
        values = []
        for kind, ln in zip(kinds, lengths):
            if kind:
                f, o = next(it)
                values.append(Ref(f, o, ln))
            else:
                values.append(r.raw(ln))
    if r.p != len(payload):
        raise ValueError(f"{what}: {len(payload) - r.p} bytes after the last entry")
    return Node(height, keys, values)


# ---- reading ----------------------------------------------------------------

class Database:
    """An OCDBT database directory, read at its newest version. Use as a
    context manager, or ``close()`` it: it keeps its data files open."""

    def __init__(self, root: str):
        self.root = root
        self.node_bytes = 0
        self.value_bytes = 0
        self._lock = threading.Lock()
        self._fds: dict[str, int] = {}
        path = os.path.join(root, MANIFEST)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{path}: no OCDBT manifest")
        with open(path, "rb") as f:
            buf = f.read()
        self.node_bytes += len(buf)
        r = _In(decode_frame(buf, MANIFEST_MAGIC, path), path)
        self.config = _read_config(r)
        if self.config.manifest_kind != 0:
            raise ValueError(f"{path}: manifest kind {self.config.manifest_kind} "
                             "(numbered manifests) is not supported")
        files = _read_files(r, "")
        n = r.varint()
        if n == 0:
            raise ValueError(f"{path}: a manifest with no version")
        r.varints(n)  # generation numbers
        heights = [r.byte() for _ in range(n)]
        ids = [_file_id(r, files) for _ in range(n)]
        offsets, lengths = r.varints(n), r.varints(n)
        # the newest version is the last one; older ones and the version
        # tree's nodes are not needed to read it
        self.root_height = heights[-1]
        self.root_ref = None if lengths[-1] == NO_ROOT else Ref(ids[-1], offsets[-1],
                                                                lengths[-1])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def _pread(self, ref: Ref) -> bytes:
        path = os.path.join(self.root, ref.file.path)
        with self._lock:
            fd = self._fds.get(path)
            if fd is None:
                try:
                    fd = os.open(path, os.O_RDONLY)
                except FileNotFoundError:
                    raise ValueError(f"{self.root}: data file {ref.file.path} is missing") \
                        from None
                self._fds[path] = fd
        out = os.pread(fd, ref.length, ref.offset)
        if len(out) != ref.length:
            raise ValueError(f"{path}: {ref.length} bytes at offset {ref.offset} were asked "
                             f"for but {len(out)} were there (truncated)")
        return out

    def _node(self, ref: Ref, height: int) -> Node:
        what = f"{os.path.join(self.root, ref.file.path)}@{ref.offset}"
        buf = self._pread(ref)
        with self._lock:
            self.node_bytes += len(buf)
        node = parse_node(decode_frame(buf, NODE_MAGIC, what), ref.file.base, what)
        if node.height != height:
            raise ValueError(f"{what}: a node of height {node.height} where {height} "
                             "is expected")
        return node

    def items(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes | Ref]]:
        """(key, value) of every key that starts with ``prefix``, in key
        order: a value is inline bytes or a ``Ref`` for ``read``. Only the
        nodes whose key range meets the prefix are read."""
        if self.root_ref is not None:
            yield from self._walk(self.root_ref, self.root_height, b"", prefix)

    def _walk(self, ref: Ref, height: int, node_prefix: bytes, prefix: bytes):
        node = self._node(ref, height)
        keys = [node_prefix + k for k in node.keys]
        if height == 0:
            for k, v in zip(keys, node.values):
                if k.startswith(prefix):
                    yield k, v
            return
        for i, (k, (common, child)) in enumerate(zip(keys, node.values)):
            # the child holds [keys[i], keys[i + 1]): skip it where that
            # range lies wholly before or after the prefix's keys
            upper = keys[i + 1] if i + 1 < len(keys) else None
            if upper is not None and upper <= prefix:
                continue
            if k > prefix and not k.startswith(prefix):
                break
            yield from self._walk(child, height - 1, k[:len(node_prefix) + common], prefix)

    def read(self, value: bytes | Ref) -> bytes:
        """A value's bytes (an indirect one read at its offset); counted in
        ``value_bytes``."""
        out = value if isinstance(value, bytes) else self._pread(value)
        with self._lock:
            self.value_bytes += len(out)
        return out


# ---- writing ----------------------------------------------------------------

def _new_file() -> str:
    return f"d/{uuid.uuid4().hex}"


class Writer:
    """Writes a new database directory at ``root``: ``put`` each key once
    (values over ``max_inline_value_bytes`` go to data files at once) or
    ``put_ref`` it, then ``commit`` writes the B-tree and the manifest."""

    def __init__(self, root: str):
        self.root = root
        self.config = Config(uuid.uuid4().bytes, 0, MAX_INLINE_VALUE_BYTES,
                             MAX_DECODED_NODE_BYTES, VERSION_TREE_ARITY_LOG2, (1, 0))
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        # key -> inline bytes, or (base, data file, offset, length)
        self.entries: dict[bytes, bytes | tuple[str, str, int, int]] = {}
        self._file: tuple[str, object] | None = None
        self._offset = 0

    def _new_key(self, key: bytes) -> None:
        if key in self.entries:
            raise ValueError(f"key {key!r} written twice")

    def put(self, key: bytes, value: bytes) -> None:
        self._new_key(key)
        if len(value) <= self.config.max_inline_value_bytes:
            self.entries[key] = bytes(value)
            return
        if self._file is None or self._offset + len(value) > DATA_FILE_BYTES \
                and self._offset:
            self._close_file()
            rel = _new_file()
            self._file = (rel, open(os.path.join(self.root, rel), "wb"))
            self._offset = 0
        rel, f = self._file
        f.write(value)
        self.entries[key] = ("", rel, self._offset, len(value))
        self._offset += len(value)

    def put_ref(self, key: bytes, base: str, rel: str, offset: int, length: int) -> None:
        """``key``'s value is ``length`` bytes at ``offset`` of the data file
        ``base + rel`` (relative to ``root``), written by another database."""
        self._new_key(key)
        self.entries[key] = (base, rel, offset, length)

    def _close_file(self) -> None:
        if self._file is not None:
            f = self._file[1]
            f.flush()
            os.fsync(f.fileno())
            f.close()
            self._file = None

    def _write_node(self, payload: bytes) -> tuple[str, int]:
        frame = encode_frame(payload, NODE_MAGIC)
        rel = _new_file()
        with open(os.path.join(self.root, rel), "wb") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        return rel, len(frame)

    def _leaf(self, items: list) -> bytes:
        keys = [k for k, _ in items]
        indirect = [v for _, v in items if not isinstance(v, bytes)]
        files = sorted({v[:2] for v in indirect}, key=lambda f: f[0] + f[1])
        fid = {f: i for i, f in enumerate(files)}
        out = bytes([0]) + _write_files(files) + _varint(len(items)) + _write_keys(keys, False)
        out += b"".join(_varint(len(v) if isinstance(v, bytes) else v[3]) for _, v in items)
        out += b"".join(_varint(0 if isinstance(v, bytes) else 1) for _, v in items)
        out += b"".join(_varint(fid[v[:2]]) for v in indirect)
        out += b"".join(_varint(v[2]) for v in indirect)
        return out + b"".join(v for _, v in items if isinstance(v, bytes))

    def _interior(self, height: int, children: list) -> bytes:
        files = sorted({c[1] for c in children})
        fid = {p: i for i, p in enumerate(files)}
        out = bytes([height]) + _write_files([("", f) for f in files]) + _varint(len(children))
        out += _write_keys([c[0] for c in children], True)
        out += b"".join(_varint(fid[c[1]]) for c in children)
        out += b"".join(_varint(0) for _ in children)  # each node is its own file
        out += b"".join(_varint(c[2]) for c in children)
        for j in (3, 4, 5):  # keys, tree bytes, indirect value bytes
            out += b"".join(_varint(c[j]) for c in children)
        return out

    def _leaves(self, items: list) -> list[list]:
        """``items`` cut into runs whose leaves stay within the node limit."""
        limit = self.config.max_decoded_node_bytes - 64
        runs, run, size = [], [], 0
        for k, v in items:
            n = len(k) + (len(v) if isinstance(v, bytes) else 40 + len(v[0]) + len(v[1])) + 16
            if run and size + n > limit:
                runs.append(run)
                run, size = [], 0
            run.append((k, v))
            size += n
        runs.append(run)
        return runs

    def commit(self) -> dict[bytes, bytes | tuple[str, int, int]]:
        """Write the B-tree and the manifest (the database's commit point),
        each file synced. Returns the entries this database's own files
        hold: key -> inline value, or (data file, offset, length)."""
        self._close_file()
        items = sorted(self.entries.items())
        level, height = [], 0
        if items:
            for run in self._leaves(items):
                rel, n = self._write_node(self._leaf(run))
                ind = sum(v[3] for _, v in run if not isinstance(v, bytes))
                level.append((run[0][0], rel, n, len(run), n, ind))
            while len(level) > 1:
                height += 1
                # interior entries are small: 16 children fit any node limit
                level = [self._interior_entry(height, level[i:i + 16])
                         for i in range(0, len(level), 16)]
        manifest = _write_config(self.config)
        if level:
            _, rel, n, keys, tree_bytes, ind = level[0]
            manifest += _write_files([("", rel)])
            root = (0, 0, n, keys, tree_bytes, ind)
        else:
            manifest += _write_files([("", "")])
            root = (0, NO_ROOT, NO_ROOT, 0, 0, 0)
        manifest += _varint(1) + _varint(1) + bytes([height])  # one version: generation 1
        manifest += b"".join(_varint(x) for x in root)
        manifest += struct.pack("<Q", time.time_ns()) + _varint(0)  # no version-tree nodes
        path = os.path.join(self.root, MANIFEST)
        with open(path, "wb") as f:
            f.write(encode_frame(manifest, MANIFEST_MAGIC))
            f.flush()
            os.fsync(f.fileno())
        return {k: v if isinstance(v, bytes) else v[1:] for k, v in self.entries.items()
                if isinstance(v, bytes) or not v[0]}

    def _interior_entry(self, height: int, children: list) -> tuple:
        rel, n = self._write_node(self._interior(height, children))
        return (children[0][0], rel, n, sum(c[3] for c in children),
                n + sum(c[4] for c in children), sum(c[5] for c in children))
