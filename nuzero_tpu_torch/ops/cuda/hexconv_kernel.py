"""Python wrappers of the CUDA hex-conv kernels: the forward
(``csrc/hexconv.cu``) and the weight gradient (``csrc/hexconv_dw.cu``).

The forward is the counterpart of
``nuzero_tpu/ops/pallas/hexconv_kernel.py:hex_conv_pallas``; the weight
gradient of the XLA VJP in ``nuzero_tpu/ops/hexconv.py:_hex_conv_pallas_bwd``
(the input gradient is the forward on mirrored taps).  Each wrapper
validates its inputs, allocates the output and scratch, launches on the
current stream and counts its launches; it never falls back to another
implementation.  The plain PyTorch versions are ``hex_conv_plain`` and
``hex_conv_dw_plain`` in ``nuzero_tpu_torch.ops.hexconv``.
"""

from __future__ import annotations

import functools
import math
import threading

import torch

from nuzero_tpu_torch.ops.cuda.build import hexconv_dw_library, hexconv_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The forward kernel (``csrc/hexconv.cu``) each dtype launches.
KERNELS = {torch.float32: "hexconv_f32_kernel", torch.bfloat16: "hexconv_bf16_wgmma_kernel"}
#: The weight-gradient kernel (``csrc/hexconv_dw.cu``) each dtype launches;
#: each launch is followed by the reduce kernel that adds its workspace
#: partials, where there is more than one.
DW_KERNELS = {torch.float32: "hexconv_dw_f32_kernel",
              torch.bfloat16: "hexconv_dw_bf16_wgmma_kernel"}
#: The pixel step of both dW kernels' slices (the f32 kernel's chunk), and
#: the most blocks of an f32 dW thread-block cluster.
DW_CHUNK, DW_MAX_CLUSTER = 16, 8

#: Launches per device kernel since the last ``reset_launch_count()``.
launch_count = {name: 0 for name in (*KERNELS.values(), *DW_KERNELS.values())}
# The training pipeline's asynchronous in-loop tests launch from a worker
# thread: an increment is a read-modify-write.
_count_lock = threading.Lock()


def reset_launch_count() -> None:
    with _count_lock:
        for name in launch_count:
            launch_count[name] = 0


def count_launch(name: str) -> None:
    with _count_lock:
        launch_count[name] += 1


def _check_operands(name, a, b):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"{name} needs both operands on one CUDA device, got {a.device} and {b.device}"
        )
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(
            f"{name} takes f32 or bf16 operands of one dtype, got {a.dtype} and {b.dtype}"
        )
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")


def hex_conv_cuda(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Hex conv of NHWC ``x`` [B, H, W, Cin] with ``weights`` [7, Cin, Cout]
    (tap order [c, n, ne, se, s, sw, nw]) on the card.  f32 or bf16, both
    operands of one dtype; accumulates in f32 and returns x's dtype."""
    _check_operands("hex_conv_cuda", x, weights)
    if x.dim() != 4 or weights.dim() != 3 or weights.shape[0] != 7:
        raise ValueError(
            f"expected x [B, H, W, Cin] and weights [7, Cin, Cout], got "
            f"{tuple(x.shape)} and {tuple(weights.shape)}"
        )
    B, H, W, Cin = x.shape
    if weights.shape[1] != Cin:
        raise ValueError(f"weights Cin {weights.shape[1]} != x Cin {Cin}")
    Cout = weights.shape[2]
    if B * H * W >= 2**31 or 7 * Cin * max(Cout, 1) >= 2**31:
        raise ValueError("hex_conv_cuda shapes exceed 32-bit indexing")
    y = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    # The current stream's handle, without building a torch.cuda.Stream
    # object on every call (host time that 527 calls per move pay).
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    err = hexconv_library().hexconv_forward(
        x.data_ptr(), weights.data_ptr(), y.data_ptr(),
        B, H, W, Cin, Cout, _DTYPES[x.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"hexconv_forward launch failed: CUDA error {err}")
    count_launch(KERNELS[x.dtype])
    return y


def dw_cluster(slices: int) -> int:
    """Blocks per thread-block cluster of the f32 dW kernel for ``slices``
    slices: the largest count up to 8 that divides them (the rule of
    ``f32::cluster_size`` in ``csrc/hexconv_dw.cu``)."""
    return max(c for c in range(1, DW_MAX_CLUSTER + 1) if slices % c == 0)


@functools.lru_cache(maxsize=None)
def dw_slices(m: int, tiles: int, capacity: tuple[int, ...]) -> tuple[int, int]:
    """(slices, pixels per slice) of the f32 dW kernel's grid for M = ``m``
    pixels and ``tiles`` blocks per slice (``hexconv_dw_blocks_per_slice``),
    where the card holds at once ``capacity[c - 1]`` clusters of c blocks
    (``hexconv_dw_max_clusters``; c = 1: blocks).  The slices are the
    shortest whole numbers of 16-pixel chunks that keep the grid in one wave
    of blocks, none empty, lengthened until they fall in clusters of at
    least 4 blocks (or in one cluster of 8 or fewer) that the card holds at
    once: the clusters' partials, not the slices', go to the workspace."""
    chunks = math.ceil(m / DW_CHUNK)
    per = math.ceil(chunks / max(1, min(capacity[0] // tiles, chunks)))
    while True:
        slices = math.ceil(chunks / per)
        cluster = dw_cluster(slices)
        if slices == 1 or ((slices <= DW_MAX_CLUSTER or cluster >= 4)
                           and tiles * (slices // cluster) <= capacity[cluster - 1]):
            return slices, per * DW_CHUNK
        per += 1


@functools.lru_cache(maxsize=None)
def dw_wgmma_slices(m: int, tiles: int, sms: int) -> tuple[int, int]:
    """(slices, pixels per slice) of the bf16 dW kernel's grid for M = ``m``
    pixels and ``tiles`` blocks per slice (``hexconv_dw_blocks_per_slice``).
    A block takes a whole SM, so the slices are the shortest whole numbers
    of 16-pixel steps that keep the grid in one wave of ``sms`` blocks (one
    slice where the tiles alone fill the card), none empty.  Each slice
    costs a [7*Cin, Cout] f32 partial in the workspace."""
    steps = math.ceil(m / DW_CHUNK)
    want = max(1, min(sms // tiles, steps))
    per_slice = math.ceil(steps / want) * DW_CHUNK
    return math.ceil(m / per_slice), per_slice


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _dw_blocks(cin: int, cout: int, code: int) -> int:
    return hexconv_dw_library().hexconv_dw_blocks_per_slice(cin, cout, code)


@functools.lru_cache(maxsize=None)
def _dw_capacity(cout: int, w: int, index: int) -> tuple[int, ...]:
    lib = hexconv_dw_library()
    with torch.cuda.device(index):
        return tuple(lib.hexconv_dw_max_clusters(cout, w, c, 0)
                     for c in range(1, DW_MAX_CLUSTER + 1))


def dw_plan(m: int, cin: int, cout: int, dtype: torch.dtype, index: int,
            w: int) -> tuple[int, int, int]:
    """(slices, pixels per slice, workspace partials) of the dW kernel of
    ``dtype`` on card ``index`` for M = ``m`` pixels of boards ``w`` wide,
    from the built library's tile rule and occupancy."""
    code = _DTYPES[dtype]
    tiles = _dw_blocks(cin, cout, code)
    if dtype == torch.bfloat16:
        slices, per = dw_wgmma_slices(m, tiles, _sm_count(index))
    else:
        slices, per = dw_slices(m, tiles, _dw_capacity(cout, w, index))
    return slices, per, hexconv_dw_library().hexconv_dw_partials(slices, code)


def hex_conv_dw_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the hex conv on the card: ``dW [7, Cin, Cout]``
    of NHWC ``x`` [B, H, W, Cin] and the output gradient ``dy``
    [B, H, W, Cout], f32 or bf16 of one dtype; f32 sums in a fixed order
    (the same bits on every run), rounded once to the operands' dtype."""
    _check_operands("hex_conv_dw_cuda", x, dy)
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(
            f"expected x [B, H, W, Cin] and dy [B, H, W, Cout], got "
            f"{tuple(x.shape)} and {tuple(dy.shape)}"
        )
    B, H, W, Cin = x.shape
    Cout = dy.shape[3]
    M = B * H * W
    if M * max(Cin, Cout) >= 2**31 or 7 * Cin * max(Cout, 1) >= 2**31:
        raise ValueError("hex_conv_dw_cuda shapes exceed 32-bit indexing")
    slices, per_slice, partials = dw_plan(M, Cin, Cout, x.dtype, x.device.index, W)
    part = torch.empty((partials, 7 * Cin, Cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((7, Cin, Cout), dtype=x.dtype, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    lib = hexconv_dw_library()
    err = lib.hexconv_dw(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
        B, H, W, Cin, Cout, _DTYPES[x.dtype], slices, per_slice, stream,
    )
    if err != 0:
        cap = lib.hexconv_dw_max_width(Cout, _DTYPES[x.dtype])
        if 0 <= cap < W:
            raise RuntimeError(
                f"hexconv_dw launch failed: a board {W} wide is past the {DW_KERNELS[x.dtype]}'s "
                f"shared-memory cap (boards up to {cap} wide at Cout {Cout})")
        raise RuntimeError(f"hexconv_dw launch failed: CUDA error {err}")
    count_launch(DW_KERNELS[x.dtype])
    return dw
