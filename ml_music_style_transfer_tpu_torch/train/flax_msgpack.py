"""A reader and writer for the msgpack files that ``flax.serialization``
writes (``to_bytes`` / ``msgpack_serialize``), in plain Python: the card's
machine has neither ``flax`` nor ``msgpack``.

The subset is what a JAX ``Trainer`` checkpoint holds: nil, booleans,
integers, float32/64, strings, bin, arrays, maps, and the extension types
flax registers (``flax/serialization.py``):
  - ext 1: an ndarray, itself msgpack ``(shape, dtype name, C-order bytes)``;
  - ext 2: a complex number, ``(real, imag)``;
  - ext 3: a numpy scalar, encoded as a 0-d ndarray.
An array of more than ``MAX_CHUNK_SIZE`` bytes (2**30, flax's constant) is
stored as ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
{"0": ..., ...}}`` of flat pieces; both directions handle it.

Reading returns dicts, lists, Python scalars and torch tensors. A tensor
is a view of the file's bytes (``torch.frombuffer`` on a slice of a
``memoryview``), so no array is copied while parsing; ``load`` maps the
file (copy-on-write), so a key it skips is never read from disk. The dtype
name ``bfloat16`` becomes ``torch.bfloat16`` (a uint16 view of the bytes).
``load(path, keys=(...))`` parses only those top-level keys and steps over
the others by their length prefixes: the way to read ``params`` without
touching the Adam moments. A chunked array is concatenated, its one copy.

Writing takes what flax's ``to_state_dict`` leaves (dicts with string
keys, Python scalars and strings, torch tensors on any device, numpy
arrays and scalars; a sequence is a dict keyed "0", "1", ... there) and
streams each array's bytes to the file, one array on the host at a time.
"""
from __future__ import annotations

import io
import mmap
import os
import struct
from typing import Any, BinaryIO, Iterable

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_TORCH = {"bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64,
          "complex64": torch.complex64, "complex128": torch.complex128}
_NAME = {v: k for k, v in _TORCH.items()}
for _u in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _u):
        _TORCH[_u] = getattr(torch, _u)
        _NAME[getattr(torch, _u)] = _u


# ---- reading ---------------------------------------------------------------

class _Reader:
    def __init__(self, buf: memoryview):
        self.b, self.p = buf, 0

    def _take(self, n: int) -> memoryview:
        if self.p + n > len(self.b):
            raise ValueError("truncated msgpack data")
        out = self.b[self.p:self.p + n]
        self.p += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _head(self) -> tuple[str, Any]:
        """The next item's kind and its length or immediate value."""
        c = self._take(1)[0]
        if c <= 0x7F:
            return "int", c
        if c >= 0xE0:
            return "int", c - 0x100
        if 0x80 <= c <= 0x8F:
            return "map", c & 0x0F
        if 0x90 <= c <= 0x9F:
            return "array", c & 0x0F
        if 0xA0 <= c <= 0xBF:
            return "str", c & 0x1F
        if c == 0xC0:
            return "nil", None
        if c in (0xC2, 0xC3):
            return "bool", c == 0xC3
        if c in (0xC4, 0xC5, 0xC6):
            return "bin", self._uint(1 << (c - 0xC4))
        if c in (0xC7, 0xC8, 0xC9):
            return "ext", self._uint(1 << (c - 0xC7))
        if c == 0xCA:
            return "float", struct.unpack(">f", self._take(4))[0]
        if c == 0xCB:
            return "float", struct.unpack(">d", self._take(8))[0]
        if 0xCC <= c <= 0xCF:
            return "int", self._uint(1 << (c - 0xCC))
        if 0xD0 <= c <= 0xD3:
            n = 1 << (c - 0xD0)
            return "int", int.from_bytes(self._take(n), "big", signed=True)
        if 0xD4 <= c <= 0xD8:
            return "ext", 1 << (c - 0xD4)
        if c in (0xD9, 0xDA, 0xDB):
            return "str", self._uint(1 << (c - 0xD9))
        if c in (0xDC, 0xDD):
            return "array", self._uint(2 << (c - 0xDC))
        if c in (0xDE, 0xDF):
            return "map", self._uint(2 << (c - 0xDE))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not in flax's subset")

    def value(self) -> Any:
        kind, n = self._head()
        if kind in ("int", "nil", "bool", "float"):
            return n
        if kind == "str":
            return str(self._take(n), "utf-8")
        if kind == "bin":
            return self._take(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            d = {}
            for _ in range(n):
                k = self.value()
                d[k] = self.value()
            return _unchunk(d) if CHUNKED in d else d
        code = int.from_bytes(self._take(1), "big", signed=True)
        return _ext(code, self._take(n))

    def skip(self) -> None:
        kind, n = self._head()
        if kind in ("str", "bin"):
            self.p += n
        elif kind == "ext":
            self.p += 1 + n
        elif kind in ("array", "map"):
            for _ in range(n if kind == "array" else 2 * n):
                self.skip()


def _tensor(shape, dtype_name: str, data: memoryview) -> torch.Tensor:
    dtype = _TORCH.get(dtype_name)
    if dtype is None:
        raise ValueError(f"dtype {dtype_name!r} is not supported")
    shape = tuple(int(s) for s in shape)
    if not data.nbytes:
        return torch.empty(shape, dtype=dtype)
    if dtype == torch.bfloat16:
        return torch.frombuffer(data, dtype=torch.int16).view(torch.bfloat16).reshape(shape)
    return torch.frombuffer(data, dtype=dtype).reshape(shape)


def _ext(code: int, data: memoryview) -> Any:
    r = _Reader(data)
    if code == EXT_COMPLEX:
        re_, im = r.value()
        return complex(re_, im)
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack extension type {code} is not flax's")
    shape, name, raw = r.value()
    t = _tensor(shape, name, raw)
    return t.item() if code == EXT_NPSCALAR else t


def _unchunk(d: dict) -> torch.Tensor:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat(chunks).reshape(shape)


def _writable(buf) -> memoryview:
    mv = memoryview(buf)
    return mv if not mv.readonly else memoryview(bytearray(mv))


def loads(data, keys: Iterable[str] | None = None) -> Any:
    """Decode msgpack bytes (a read-only buffer is copied once, since
    tensors view it). ``keys``: parse only those keys of the top-level
    map."""
    r = _Reader(_writable(data).cast("B"))
    if keys is None:
        return r.value()
    keys = set(keys)
    kind, n = r._head()
    if kind != "map":
        raise ValueError("keys= needs a map at the top level")
    out = {}
    for _ in range(n):
        k = r.value()
        if k in keys:
            out[k] = r.value()
        else:
            r.skip()
    return out


def load(path: str, keys: Iterable[str] | None = None) -> Any:
    """Decode the file at ``path``, mapped copy-on-write: tensors view the
    mapping, and the bytes of skipped keys are not read."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return loads(mm, keys)


# ---- writing ---------------------------------------------------------------

def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                           (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
        if -lim <= v:
            return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"{v} does not fit msgpack's 64-bit integers")


def _len_head(n: int, fix: int | None, fix_max: int, codes: tuple[int, ...]) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack item of length {n}")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _len_head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _ext_head(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _len_head(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _host_bytes(t: torch.Tensor) -> memoryview:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    if not t.numel():
        return memoryview(b"")
    return memoryview(t.numpy()).cast("B")


class _Writer:
    def __init__(self, out: BinaryIO):
        self.out = out

    def pack(self, v: Any) -> None:
        w = self.out.write
        if v is None:
            w(b"\xc0")
        elif isinstance(v, bool):
            w(b"\xc3" if v else b"\xc2")
        elif isinstance(v, int):
            w(_int(v))
        elif isinstance(v, float):
            w(b"\xcb" + struct.pack(">d", v))
        elif isinstance(v, str):
            w(_str(v))
        elif isinstance(v, dict):
            w(_len_head(len(v), 0x80, 15, (None, 0xDE, 0xDF)))
            for k, x in v.items():
                self.pack(str(k))
                self.pack(x)
        elif isinstance(v, np.generic):
            self._array(torch.from_numpy(np.asarray(v).copy()), EXT_NPSCALAR)
        elif isinstance(v, (torch.Tensor, np.ndarray)):
            # (np.ascontiguousarray would make a 0-d array 1-d)
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, order="C"))
            if t.numel() * t.element_size() > MAX_CHUNK_SIZE:
                self.pack(_chunk(t))
            else:
                self._array(t, EXT_NDARRAY)
        elif isinstance(v, complex):
            body = b"\x92" + b"\xcb" + struct.pack(">d", v.real) + b"\xcb" + struct.pack(">d", v.imag)
            w(_ext_head(EXT_COMPLEX, len(body)) + body)
        else:
            raise TypeError(f"cannot write {type(v).__name__} as flax msgpack")

    def _array(self, t: torch.Tensor, code: int) -> None:
        name = _NAME.get(t.dtype)
        if name is None:
            raise TypeError(f"dtype {t.dtype} is not supported")
        data = _host_bytes(t)
        shape = b"".join([_len_head(t.dim(), 0x90, 15, (None, 0xDC, 0xDD))]
                         + [_int(int(s)) for s in t.shape])
        prefix = b"\x93" + shape + _str(name) + _len_head(data.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
        self.out.write(_ext_head(code, len(prefix) + data.nbytes) + prefix)
        self.out.write(data)


def _chunk(t: torch.Tensor) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / t.element_size()))
    flat = t.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(t.shape)},
            "chunks": {str(i): flat[lo:lo + size]
                       for i, lo in enumerate(range(0, flat.numel(), size))}}


def dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _Writer(buf).pack(obj)
    return buf.getvalue()


def dump(obj: Any, path: str) -> str:
    """Write ``obj`` to ``path`` through a temporary file, so a crash
    mid-write never leaves a truncated file under its name."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        _Writer(f).pack(obj)
    os.replace(tmp, path)
    return path
