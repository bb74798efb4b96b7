"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` into a shared
library with a plain C interface and loaded through ``ctypes``.  The build
runs at first use, from the sources in this checkout only, into
``_build/`` beside this file (git-ignored).  The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt.

Nothing here runs at import time: the CPU test suite imports every module
and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str, sources: tuple[str, ...]) -> str:
    """Compile ``sources`` (file names under ``csrc/``) into
    ``_build/lib<name>-<hash>.so`` unless that file exists; returns its path."""
    paths = [os.path.join(CSRC, s) for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def hexconv_library() -> ctypes.CDLL:
    """The hex-conv kernel library, built on first call."""
    lib = ctypes.CDLL(build("hexconv", ("hexconv.cu",)))
    fn = lib.hexconv_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib
