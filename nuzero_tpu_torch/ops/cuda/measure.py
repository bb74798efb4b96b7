"""Shapes, bounds and timers for measuring the hex-conv kernels on the card.

Used by ``chip_smoke.py`` (repository root) and ``tune_f32.py`` (beside
this file).  Nothing here touches the card at import time.
"""

from __future__ import annotations

import subprocess

CONVS_PER_EVAL = 17
# Recurrent iterations of the training recipe (train_iterations: [4]) and
# its batch: one update's hex convs see B=256 5x5 boards, M = 6400 pixels.
TRAIN_ITERS, TRAIN_BATCH = 4, 256
# Peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 on the tensor
# cores, f32 on the CUDA cores (the f32 kernel keeps f32 rounding, so TF32
# is not its roofline), and device memory.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# (B, H, W, Cin, Cout) of the f32 kernel's ragged cases: odd Cin, pixel
# counts off the block size, odd and even widths, Cout of 1 and 42.
RAGGED = ((3, 7, 7, 21, 16), (2, 6, 6, 42, 1), (5, 5, 8, 64, 42), (4, 5, 5, 86, 70),
          (1, 9, 9, 150, 96))
# (B, H, W, Cin, Cout) of forward convs whose backward is checked off the
# training path: dW with Cin 1 and 21 and Cout 1 and 342, dX (the forward
# kernel with Cin and Cout swapped) with Cin 1 and 21 and Cout 342, 150,
# 138 and 86; odd widths; pixel counts off the dW kernel's 16-pixel chunk.
BACKWARD_RAGGED = ((4, 5, 5, 64, 1), (3, 5, 5, 138, 21), (2, 5, 5, 342, 256),
                   (3, 7, 7, 150, 64), (5, 3, 9, 86, 21), (2, 6, 6, 21, 1),
                   (1, 5, 7, 1, 342), (3, 5, 5, 256, 86))

# The transfer sweeps (``evaluation/sweeps.py``: the committed 64-filter
# solo-scout nets, f32): B=64 games on boards of 5x5 to 15x15, 67
# observation channels and 12 policy planes, at 2, 6 and 24 iterations.
SWEEP_BATCH = 64
SWEEP_SIZES = (5, 7, 9, 11, 13, 15)
SWEEP_ITERS = (2, 6, 24)


def conv_shapes(filters: int, obs_channels: int = 86, policy_channels: int = 21,
                iterations: int = 2):
    """(Cin, Cout, count) of the hex convs of one RecurrentNet evaluation
    at ``iterations`` iterations, 2 blocks, recall."""
    from nuzero_tpu_torch.networks.blocks import _ramp

    shapes = [(obs_channels, filters, 1), (filters + obs_channels, filters, iterations),
              (filters, filters, 4 * iterations)]
    for head in (_ramp(filters, policy_channels, 2), _ramp(filters, 1, 4)):
        ins = [filters] + list(head[:-1])
        shapes += [(i, o, 1) for i, o in zip(ins, head)]
    assert sum(n for _, _, n in shapes) == 7 + 5 * iterations
    return shapes


def value_head_conv_shapes(head: str, filters: int):
    """(Cin, Cout) of the hex convs of value head ``head`` on a hex trunk
    of ``filters`` channels, read off the head that ``make_value_head``
    builds, in the order it holds them, which is their call order.  The
    heads' 1x1, grouped and depthwise convs are no hex convs and launch no
    kernel."""
    from nuzero_tpu_torch.networks.blocks import HexConv, make_value_head

    module = make_value_head(head, filters, hex=True, board_shape=(5, 5))
    return [tuple(m.weight.shape[1:]) for m in module.modules() if isinstance(m, HexConv)]


def convs_per_evaluation(head: str = "reduce", iterations: int = 2) -> int:
    """Hex convs of one hex RecurrentNet evaluation (2 blocks, recall) with
    value head ``head``: the stem, 5 per iteration, the policy ramp's 2 and
    the head's."""
    return 3 + 5 * iterations + len(value_head_conv_shapes(head, 64))


def sweep_conv_shapes(iterations: int = 2):
    """(Cin, Cout, count) of one evaluation of the sweeps' nets."""
    return conv_shapes(64, obs_channels=67, policy_channels=12, iterations=iterations)


def launches_per_update(iterations: int = TRAIN_ITERS) -> dict:
    """Kernel launches of one learner update with the progressive loss off
    (one forward at ``iterations``): every hex conv launches the forward
    kernel once forward and the dW kernel once backward, and every conv but
    the stem (whose input is the observation) the forward kernel once more
    for dX."""
    convs = 7 + 5 * iterations
    return {"forward": convs, "dx": convs - 1, "dw": convs}


def launches_per_progressive_update(iterations: int, n: int, k: int) -> dict:
    """Kernel launches of one learner update with the progressive loss on
    and its draws ``(n, k)`` (``training/learner.py:progressive_draws``):
    ``launches_per_update`` for the full forward, plus a second forward of
    ``n + k`` iterations whose thought is detached at iteration ``n`` (none
    where n is 0).  Its backward reaches only the convs after the detach
    and the heads (6 convs), and no dX where a conv's input is detached
    (the first conv of iteration ``n``, the recall on the detached thought
    and the observation) or is the observation (the stem)."""
    base = launches_per_update(iterations)
    convs = 7 + 5 * (n + k)
    if n == 0:
        dw, dx = convs, convs - 1
    else:
        dw, dx = 5 * k + 6, 5 * k + 5
    return {"forward": base["forward"] + convs, "dx": base["dx"] + dx, "dw": base["dw"] + dw}


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


def dual3x3_weight_grad_to_taps(dk, cin: int, cout: int):
    """The hex weight gradient [7, Cin, Cout] from the gradient of the dual
    3x3 weights ``[2*Cout, Cin, 3, 3]`` (``ops.hexconv.dual3x3_weights``):
    each tap's weights sit in both parity kernels, so its gradient is the
    sum of the two."""
    from nuzero_tpu_torch.ops.hexconv import hex_neighbor_offsets

    dk = dk.reshape(2, cout, cin, 3, 3)
    total = 0
    for parity in (0, 1):
        offs = hex_neighbor_offsets(parity)
        total = total + dk[parity, :, :, offs[:, 0] + 1, offs[:, 1] + 1].permute(2, 1, 0)
    return total


def library_backward(x, weights, dy):
    """The JAX package's backward as cuDNN calls (the library yardstick of
    the dX and dW kernels): the VJP of the dual 3x3 conv, dY stacked as
    [dY on even columns, dY on odd columns] against ``dual3x3_weights``.
    Returns (dx_call, dw_call, to_hex): the two ``convolution_backward``
    calls, input-grad and weight-grad, on prepared NCHW views, and a map of
    their outputs to the hex layout [B, H, W, Cin] and [7, Cin, Cout]."""
    import torch

    from nuzero_tpu_torch.ops.hexconv import dual3x3_weights

    cin, cout, W = x.shape[3], dy.shape[3], x.shape[2]
    odd = (torch.arange(W, device=x.device) % 2).to(dy.dtype).view(1, 1, W, 1)
    dy2 = torch.cat([dy * (1 - odd), dy * odd], dim=3).permute(0, 3, 1, 2)
    xn, k = x.permute(0, 3, 1, 2), dual3x3_weights(weights)
    back = torch.ops.aten.convolution_backward

    def call(mask):
        return back(dy2, xn, k, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)

    def to_hex(dx, dk):
        return dx.permute(0, 2, 3, 1), dual3x3_weight_grad_to_taps(dk, cin, cout)

    return (lambda: call([True, False, False])[0], lambda: call([False, True, False])[1],
            to_hex)
