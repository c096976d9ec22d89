"""The host IO codec of the wire formats (counterpart of
sgfhe_tpu/native.py): bit packing, dense packing of w-bit values and the
CRC32 of a frame, in C++ (csrc/sgfhe_io.cpp) loaded by ctypes.

The library is built with g++ at first use into build/native/ at the root
of the checkout (git-ignored); its file name carries a hash of the source
and flags, so an edited source is rebuilt. There is no fallback: where it
cannot be built, every codec function raises. The plain numpy versions
(`plain_*`) compute the same results and serve the tests; at Params(1024)
the numpy `pack_uint` would expand a key frame's 151 M residues into about
4.4 GB of bit bytes.

Inputs are numpy arrays or any buffer (bytes, memoryview); packed outputs
are numpy uint8 arrays, so a frame is assembled without copying them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "sgfhe_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsgfhe_io-{digest}.so"


def _build(target: Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the IO codec cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([cxx, *FLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builds agree


def load() -> ctypes.CDLL:
    """The codec library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            lib.sgfhe_packbits.argtypes = [_U8P, ctypes.c_size_t, _U8P]
            lib.sgfhe_unpackbits.argtypes = [_U8P, ctypes.c_size_t, _U8P]
            lib.sgfhe_pack_uint.argtypes = [_U32P, ctypes.c_size_t, ctypes.c_uint, _U8P]
            lib.sgfhe_unpack_uint.argtypes = [_U8P, ctypes.c_size_t, ctypes.c_uint, _U32P]
            for fn in (lib.sgfhe_packbits, lib.sgfhe_unpackbits, lib.sgfhe_pack_uint,
                       lib.sgfhe_unpack_uint):
                fn.restype = None
            lib.sgfhe_crc32.argtypes = [_U8P, ctypes.c_size_t, ctypes.c_uint32]
            lib.sgfhe_crc32.restype = ctypes.c_uint32
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray, kind):
    return arr.ctypes.data_as(kind)


def _bytes_in(data, n_bytes: int) -> np.ndarray:
    """A uint8 view of a buffer holding at least n_bytes."""
    if isinstance(data, np.ndarray):  # the array's bytes, whatever its dtype
        buf = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size < n_bytes:
        raise ValueError(f"truncated data: {buf.size} bytes, {n_bytes} needed")
    return buf


def _check_width(width: int) -> None:
    if not 1 <= width <= 32:
        raise ValueError(f"width {width} outside 1..32")


def packbits(bits: np.ndarray) -> np.ndarray:
    """Little-endian bit packing (== np.packbits(bitorder='little'))."""
    bits = np.ascontiguousarray(np.asarray(bits).reshape(-1), dtype=np.uint8)
    out = np.empty((bits.size + 7) // 8, dtype=np.uint8)
    load().sgfhe_packbits(_ptr(bits, _U8P), bits.size, _ptr(out, _U8P))
    return out


def unpackbits(data, n_bits: int) -> np.ndarray:
    buf = _bytes_in(data, (n_bits + 7) // 8)
    out = np.empty(n_bits, dtype=np.uint8)
    load().sgfhe_unpackbits(_ptr(buf, _U8P), n_bits, _ptr(out, _U8P))
    return out


def pack_uint(vals: np.ndarray, width: int) -> np.ndarray:
    """Dense little-endian packing of `width`-bit values (uint32 input)."""
    _check_width(width)
    vals = np.ascontiguousarray(np.asarray(vals).reshape(-1), dtype=np.uint32)
    out = np.empty((vals.size * width + 7) // 8, dtype=np.uint8)
    load().sgfhe_pack_uint(_ptr(vals, _U32P), vals.size, width, _ptr(out, _U8P))
    return out


def unpack_uint(data, count: int, width: int) -> np.ndarray:
    _check_width(width)
    buf = _bytes_in(data, (count * width + 7) // 8)
    out = np.empty(count, dtype=np.uint32)
    load().sgfhe_unpack_uint(_ptr(buf, _U8P), count, width, _ptr(out, _U32P))
    return out


def crc32(data, seed: int = 0) -> int:
    """CRC32 of a buffer, continuing from `seed` (== zlib.crc32)."""
    buf = _bytes_in(data, 0)
    return int(load().sgfhe_crc32(_ptr(buf, _U8P), buf.size, seed & 0xFFFFFFFF))


# -- the plain numpy versions -------------------------------------------------


def plain_packbits(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=np.uint8).reshape(-1), bitorder="little")


def plain_unpackbits(data, n_bits: int) -> np.ndarray:
    return np.unpackbits(_bytes_in(data, (n_bits + 7) // 8), count=n_bits, bitorder="little")


def plain_pack_uint(vals: np.ndarray, width: int) -> np.ndarray:
    _check_width(width)
    vals = np.asarray(vals, dtype=np.uint32).reshape(-1)
    bits = ((vals[:, None] >> np.arange(width, dtype=np.uint32)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little")


def plain_unpack_uint(data, count: int, width: int) -> np.ndarray:
    _check_width(width)
    bits = plain_unpackbits(data, count * width).reshape(count, width).astype(np.uint32)
    return (bits << np.arange(width, dtype=np.uint32)).sum(axis=1, dtype=np.uint32)


def plain_crc32(data, seed: int = 0) -> int:
    return zlib.crc32(_bytes_in(data, 0), seed) & 0xFFFFFFFF
