"""Python wrapper of the CUDA hex-conv kernel (``csrc/hexconv.cu``).

Counterpart of ``nuzero_tpu/ops/pallas/hexconv_kernel.py:hex_conv_pallas``.
The wrapper validates its inputs, allocates the output, launches on the
current stream and counts its launches; it never falls back to another
implementation.  The plain PyTorch version of the same function is
``nuzero_tpu_torch.ops.hexconv.hex_conv_plain``.
"""

from __future__ import annotations

import torch

from nuzero_tpu_torch.ops.cuda.build import hexconv_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The device kernel (``csrc/hexconv.cu``) each dtype launches.
KERNELS = {torch.float32: "hexconv_f32_kernel", torch.bfloat16: "hexconv_bf16_wgmma_kernel"}

#: Launches per device kernel since the last ``reset_launch_count()``.
launch_count = {name: 0 for name in KERNELS.values()}


def reset_launch_count() -> None:
    for name in launch_count:
        launch_count[name] = 0


def hex_conv_cuda(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Hex conv of NHWC ``x`` [B, H, W, Cin] with ``weights`` [7, Cin, Cout]
    (tap order [c, n, ne, se, s, sw, nw]) on the card.  f32 or bf16, both
    operands of one dtype; accumulates in f32 and returns x's dtype."""
    if x.device.type != "cuda" or weights.device != x.device:
        raise ValueError(
            f"hex_conv_cuda needs both operands on one CUDA device, got "
            f"{x.device} and {weights.device}"
        )
    if x.dtype not in _DTYPES or weights.dtype != x.dtype:
        raise TypeError(
            f"hex_conv_cuda takes f32 or bf16 operands of one dtype, got "
            f"{x.dtype} and {weights.dtype}"
        )
    if x.dim() != 4 or weights.dim() != 3 or weights.shape[0] != 7:
        raise ValueError(
            f"expected x [B, H, W, Cin] and weights [7, Cin, Cout], got "
            f"{tuple(x.shape)} and {tuple(weights.shape)}"
        )
    B, H, W, Cin = x.shape
    if weights.shape[1] != Cin:
        raise ValueError(f"weights Cin {weights.shape[1]} != x Cin {Cin}")
    if not (x.is_contiguous() and weights.is_contiguous()):
        raise ValueError("hex_conv_cuda needs contiguous operands")
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
    launch_count[KERNELS[x.dtype]] += 1
    return y
