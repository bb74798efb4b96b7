"""Shapes, bounds and timers for measuring the hex-conv kernels on the card.

Used by ``chip_smoke.py`` (repository root) and ``tune_f32.py`` (beside
this file).  Nothing here touches the card at import time.
"""

from __future__ import annotations

import subprocess

CONVS_PER_EVAL = 17
# Peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 on the tensor
# cores, f32 on the CUDA cores (the f32 kernel keeps f32 rounding, so TF32
# is not its roofline), and device memory.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# (B, H, W, Cin, Cout) of the f32 kernel's ragged cases: odd Cin, pixel
# counts off the block size, odd and even widths, Cout of 1 and 42.
RAGGED = ((3, 7, 7, 21, 16), (2, 6, 6, 42, 1), (5, 5, 8, 64, 42), (4, 5, 5, 86, 70),
          (1, 9, 9, 150, 96))


def conv_shapes(filters: int, obs_channels: int = 86, policy_channels: int = 21):
    """(Cin, Cout, count) of the hex convs of one RecurrentNet evaluation
    at 2 iterations, 2 blocks, recall."""
    from nuzero_tpu_torch.networks.blocks import _ramp

    shapes = [(obs_channels, filters, 1), (filters + obs_channels, filters, 2),
              (filters, filters, 8)]
    for head in (_ramp(filters, policy_channels, 2), _ramp(filters, 1, 4)):
        ins = [filters] + list(head[:-1])
        shapes += [(i, o, 1) for i, o in zip(ins, head)]
    assert sum(n for _, _, n in shapes) == CONVS_PER_EVAL
    return shapes


def bound(dtype_name, batch, rows, cols, cin, cout):
    """The least time (ms) the card could take for one hex conv, and what
    bounds it: 2*7*M*Cin*Cout operations at the dtype's peak, or x, W and y
    each moved once at the memory rate."""
    m = batch * rows * cols
    size = 2 if dtype_name == "bfloat16" else 4
    ops_ms = 2 * 7 * m * cin * cout / PEAK_FLOPS[dtype_name] * 1e3
    bytes_ms = (m * cin + 7 * cin * cout + m * cout) * size / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` over a loop of ``reps`` calls, by CUDA events:
    device time, or the host's rate of calls where that is slower."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` as ``reps`` calls captured in one CUDA graph and
    replayed: device time without the host's rate of calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
