"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` into a shared
library with a plain C interface and loaded through ``ctypes``.  The build
runs at first use, from the sources in this checkout only, into
``_build/`` beside this file (git-ignored).  The library's file name
carries a hash of the sources, of every header under ``csrc/`` (which any
source may include) and of the flags, so an edited source or header is
rebuilt.

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
from concurrent.futures import ThreadPoolExecutor

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


def library_path(name: str, sources: tuple[str, ...]) -> str:
    """``_build/lib<name>-<hash>.so``, the hash taken over the flags, the
    ``sources`` (file names under ``csrc/``) and every ``csrc/*.cuh``
    header."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [os.path.join(CSRC, n) for n in (*sources, *headers)]:
        digest.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str, sources: tuple[str, ...]) -> str:
    """Compile ``sources`` (file names under ``csrc/``) into
    ``library_path(name, sources)`` unless that file exists; returns its
    path.  Sources include headers from ``csrc/``."""
    out = library_path(name, sources)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    paths = [os.path.join(CSRC, s) for s in sources]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, *paths]
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
    """The hex-conv kernel library (``csrc/hexconv.cu``), built on first
    call."""
    lib = ctypes.CDLL(build("hexconv", ("hexconv.cu",)))
    fn = lib.hexconv_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def hexconv_dw_library() -> ctypes.CDLL:
    """The hex conv's weight-gradient kernels (``csrc/hexconv_dw.cu``),
    built on first call."""
    lib = ctypes.CDLL(build("hexconv_dw", ("hexconv_dw.cu",)))
    fn = lib.hexconv_dw
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.hexconv_dw_max_width.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hexconv_dw_max_width.restype = ctypes.c_int
    lib.hexconv_dw_blocks_per_slice.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.hexconv_dw_blocks_per_slice.restype = ctypes.c_int
    lib.hexconv_dw_partials.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hexconv_dw_partials.restype = ctypes.c_int
    lib.hexconv_dw_max_clusters.argtypes = [ctypes.c_int] * 4
    lib.hexconv_dw_max_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def graph_loop_library() -> ctypes.CDLL:
    """The while-node helpers of ``nuzero_tpu_torch.utils.graphs.run_while``
    (``csrc/graph_loop.cu``), built on first call."""
    lib = ctypes.CDLL(build("graph_loop", ("graph_loop.cu",)))
    lib.graph_while_begin.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(ctypes.c_ulonglong)]
    lib.graph_while_begin.restype = ctypes.c_int
    lib.graph_while_end.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
    lib.graph_while_end.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def scs_step_library() -> ctypes.CDLL:
    """The SCS env's step kernel (``csrc/scs_step.cu``), built on first call."""
    lib = ctypes.CDLL(build("scs_step", ("scs_step.cu",)))
    pointers = ctypes.POINTER(ctypes.c_void_p)
    lib.scs_step.argtypes = [
        pointers, ctypes.POINTER(ctypes.c_longlong), pointers,
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_int] * 7, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.scs_step.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def search_descend_library() -> ctypes.CDLL:
    """The search's PUCT descent kernel (``csrc/search_descend.cu``), built on
    first call."""
    lib = ctypes.CDLL(build("search_descend", ("search_descend.cu",)))
    lib.search_descend.argtypes = [
        *[ctypes.c_void_p] * 14, *[ctypes.c_int] * 4, *[ctypes.c_float] * 4, ctypes.c_void_p,
    ]
    lib.search_descend.restype = ctypes.c_int
    return lib


#: Every kernel library by name, with its loader (the source each builds).
LIBRARIES = {"hexconv": hexconv_library, "hexconv_dw": hexconv_dw_library,
             "graph_loop": graph_loop_library, "scs_step": scs_step_library,
             "search_descend": search_descend_library}


def build_all() -> dict:
    """Build every kernel library at once (``LIBRARIES``), one ``nvcc`` per
    source running side by side; returns {library name: CDLL}."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        futures = {name: pool.submit(load) for name, load in LIBRARIES.items()}
        return {name: f.result() for name, f in futures.items()}
