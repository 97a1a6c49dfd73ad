"""zstd for orbax checkpoints: ``ctypes`` on the system's ``libzstd.so.1``.

Orbax compresses every zarr chunk, and tensorstore every OCDBT node, as
one zstd frame (level 1). The library is loaded by its soname at first
use (not when this module is imported); Debian and Ubuntu images carry it,
since dpkg links against it. ctypes releases the GIL while the library
runs, so chunks decode in parallel threads.

``decompress_into`` writes a frame straight into a caller's buffer (a
tensor's storage) of the size the caller expects; a frame that declares
another size, or decodes to another size, raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

CONTENTSIZE_UNKNOWN = 2**64 - 1
CONTENTSIZE_ERROR = 2**64 - 2
LEVEL = 1  # orbax's zarr compressor: {"id": "zstd", "level": 1}
MAX_DECODED = 1 << 31  # the most ``decompress`` grows its buffer to

_LOCK = threading.Lock()
_LIB: list = []


def lib() -> ctypes.CDLL:
    """The loaded ``libzstd.so.1`` with its functions' signatures; raises
    ``OSError`` naming the library where the system has none."""
    with _LOCK:
        if not _LIB:
            try:
                so = ctypes.CDLL("libzstd.so.1")
            except OSError as e:
                raise OSError(f"libzstd.so.1 is needed to read and write orbax "
                              f"checkpoints: {e}") from e
            size_t, cp = ctypes.c_size_t, ctypes.c_void_p
            for name, res, args in (
                    ("ZSTD_versionNumber", ctypes.c_uint, []),
                    ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [cp, size_t]),
                    ("ZSTD_decompress", size_t, [cp, size_t, cp, size_t]),
                    ("ZSTD_compress", size_t, [cp, size_t, cp, size_t, ctypes.c_int]),
                    ("ZSTD_compressBound", size_t, [size_t]),
                    ("ZSTD_isError", ctypes.c_uint, [size_t]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [size_t])):
                fn = getattr(so, name)
                fn.restype, fn.argtypes = res, args
            _LIB.append(so)
        return _LIB[0]


def version() -> str:
    """The library's version, e.g. ``"1.5.5"``."""
    n = lib().ZSTD_versionNumber()
    return f"{n // 10000}.{n // 100 % 100}.{n % 100}"


def _check(code: int, what: str) -> int:
    so = lib()
    if so.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {so.ZSTD_getErrorName(code).decode()}")
    return code


def _src(data) -> tuple[ctypes.c_void_p | int, int, object]:
    """(pointer, length, object to keep alive) of bytes-like ``data`` or of
    a contiguous CPU tensor's storage."""
    if isinstance(data, torch.Tensor):
        if data.device.type != "cpu" or not data.is_contiguous():
            raise ValueError("zstd reads contiguous CPU tensors")
        return data.data_ptr(), data.numel() * data.element_size(), data
    if isinstance(data, bytes):
        return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data), data
    mv = memoryview(data).cast("B")
    if mv.readonly:
        b = bytes(mv)
        return ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p), len(b), b
    buf = (ctypes.c_char * len(mv)).from_buffer(mv)
    return ctypes.addressof(buf), len(mv), buf


def content_size(frame) -> int | None:
    """The decoded size a frame's header declares, or None where it does
    not declare one."""
    ptr, n, keep = _src(frame)
    size = lib().ZSTD_getFrameContentSize(ptr, n)
    del keep
    if size == CONTENTSIZE_ERROR:
        raise ValueError(f"not a zstd frame ({bytes(memoryview(frame)[:4]).hex()} ...)")
    return None if size == CONTENTSIZE_UNKNOWN else size


def decompress_into(frame, dst: int, size: int) -> None:
    """Decode ``frame`` into the ``size`` bytes at address ``dst``. Raises
    where the frame declares or decodes to another size."""
    declared = content_size(frame)
    if declared is not None and declared != size:
        raise ValueError(f"zstd frame holds {declared} bytes where {size} are expected")
    ptr, n, keep = _src(frame)
    got = _check(lib().ZSTD_decompress(dst, size, ptr, n), "decompress")
    del keep
    if got != size:
        raise ValueError(f"zstd frame decoded to {got} bytes where {size} are expected")


def decompress(frame) -> bytes:
    """Decode ``frame`` whole, where the caller does not know its size (an
    OCDBT node, which tensorstore keeps under 100 MB)."""
    declared = content_size(frame)
    cap = declared if declared is not None else max(4 * len(memoryview(frame).cast("B")), 1024)
    while True:
        out = ctypes.create_string_buffer(max(cap, 1))
        ptr, n, keep = _src(frame)
        code = lib().ZSTD_decompress(out, cap, ptr, n)
        del keep
        if not lib().ZSTD_isError(code):
            return ctypes.string_at(out, code)
        if declared is not None or cap >= MAX_DECODED or b"Destination buffer is too small" \
                not in lib().ZSTD_getErrorName(code):
            _check(code, "decompress")
        cap = min(2 * cap, MAX_DECODED)


def compress(data) -> bytes:
    """One zstd frame of ``data`` (bytes-like, or a contiguous CPU
    tensor's bytes) at orbax's level, with its content size."""
    ptr, n, keep = _src(data)
    bound = lib().ZSTD_compressBound(n)
    out = ctypes.create_string_buffer(bound)
    got = _check(lib().ZSTD_compress(out, bound, ptr, n, LEVEL), "compress")
    del keep
    return ctypes.string_at(out, got)
