"""The port's native (C++) host code, loaded with ctypes (counterpart of
``nuzero_tpu/native``): xxHash64 for the keyless inference cache.

``xxhash.cpp`` is the port's own copy.  It is built with ``g++`` at first
use into ``_build/`` beside it (git-ignored), under a name keyed by a
digest of the source, so an edited source never loads a stale library.
The JAX package's library is never loaded.  Where no ``g++`` is found or
the build fails, the same hash runs in pure Python (``xxh64_py``), bit for
bit the native one's, only slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "xxhash.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
_lib: Optional[ctypes.CDLL] = None
_tried = False

_MASK = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libnuzero_native-{digest}.so")


def _build(path: str) -> None:
    """Compile ``xxhash.cpp`` into ``path`` (atomically: a concurrent build
    of the same source writes the same file)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("no C++ compiler (g++) found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The native library, built at the first call; None where it cannot be
    built (the callers then hash in pure Python)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    try:
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.xxh64.restype = ctypes.c_uint64
    lib.xxh64.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    _lib = lib
    return _lib


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _MASK, 31) * _P1) & _MASK


def xxh64_py(data: bytes, seed: int = 0) -> int:
    """xxHash64 of ``data`` in pure Python (``xxhash.cpp``'s algorithm)."""
    n = len(data)
    p = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _MASK, (seed + _P2) & _MASK, seed & _MASK,
             (seed - _P1) & _MASK]
        while p + 32 <= n:
            for i in range(4):
                v[i] = _round(v[i], int.from_bytes(data[p:p + 8], "little"))
                p += 8
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _MASK
        for lane in v:
            h = ((h ^ _round(0, lane)) * _P1 + _P4) & _MASK
    else:
        h = (seed + _P5) & _MASK
    h = (h + n) & _MASK
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _MASK
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _MASK
        h = (_rotl(h, 23) * _P2 + _P3) & _MASK
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _MASK
        h = (_rotl(h, 11) * _P1) & _MASK
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _MASK
    h ^= h >> 29
    h = (h * _P3) & _MASK
    h ^= h >> 32
    return h


def xxh64(data: bytes, seed: int = 0) -> int:
    lib = load()
    if lib is None:
        return xxh64_py(data, seed)
    return int(lib.xxh64(data, len(data), seed))

