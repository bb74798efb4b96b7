"""The yardstick's arithmetic: peaks, a hex conv's operations and bytes, its
roofline bound, and the hex convs of one RecurrentNet evaluation and of one
learner update.  Copied, frozen, from the port's ``ops/cuda/measure.py``
(``bound``, ``conv_shapes``, ``launches_per_update`` and the peaks) and
``networks/blocks.py`` (``_ramp``); plain Python, no import of the port.
"""

from __future__ import annotations

# Peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 on the tensor
# cores, f32 on the CUDA cores (the f32 kernel keeps f32 rounding, so TF32
# is not its roofline), and device memory.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def ramp(start: int, end: int, num_layers: int):
    """The reference's filter-ramp arithmetic (``int(width + k*step)``)."""
    step = (end - start) / num_layers
    sizes, prev = [], float(start)
    for _ in range(num_layers):
        prev = prev + step
        sizes.append(int(prev))
    return sizes


def conv_shapes(filters: int, obs_channels: int, policy_channels: int, iterations: int):
    """(Cin, Cout, count) of the hex convs of one RecurrentNet evaluation at
    ``iterations`` iterations: 2 BasicBlocks, recall, the reduce heads."""
    shapes = [(obs_channels, filters, 1), (filters + obs_channels, filters, iterations),
              (filters, filters, 4 * iterations)]
    for head in (ramp(filters, policy_channels, 2), ramp(filters, 1, 4)):
        ins = [filters] + list(head[:-1])
        shapes += [(i, o, 1) for i, o in zip(ins, head)]
    if sum(n for _, _, n in shapes) != 7 + 5 * iterations:
        raise AssertionError("conv count off the 7 + 5 * iterations of the net")
    return shapes


def conv_flops(pixels: int, cin: int, cout: int) -> float:
    """Operations of one hex conv over ``pixels`` = B*H*W output pixels:
    7 taps, a multiply and an add each."""
    return 2.0 * 7 * pixels * cin * cout


def conv_bytes(dtype_name: str, pixels: int, cin: int, cout: int) -> float:
    """Bytes of one hex conv with each input and output byte counted once:
    x [M, Cin], W [7, Cin, Cout] and y [M, Cout] in the compute dtype."""
    size = 2 if dtype_name == "bfloat16" else 4
    return float((pixels * cin + 7 * cin * cout + pixels * cout) * size)


def bound_s(dtype_name: str, pixels: int, cin: int, cout: int) -> float:
    """The least time (s) the card could take for one hex conv: its
    operations at the dtype's peak or its bytes at the memory rate,
    whichever is longer.  dX (the forward on mirrored taps, Cin and Cout
    swapped) and dW (7 products [Cin, M] x [M, Cout]) move and compute the
    same amounts."""
    return max(conv_flops(pixels, cin, cout) / PEAK_FLOPS[dtype_name],
               conv_bytes(dtype_name, pixels, cin, cout) / PEAK_BYTES)


def evaluation_convs(filters, obs_channels, policy_channels, iterations):
    """[(Cin, Cout)] of every hex conv of one evaluation, one entry per conv."""
    return [(i, o) for i, o, n in conv_shapes(filters, obs_channels, policy_channels,
                                              iterations) for _ in range(n)]


def evaluation_flops(pixels, filters, obs_channels, policy_channels, iterations) -> float:
    """Operations of one evaluation over ``pixels`` = B*H*W: its hex convs.
    The net has no dense or 1x1 layer; elementwise work is not counted."""
    return sum(conv_flops(pixels, i, o)
               for i, o in evaluation_convs(filters, obs_channels, policy_channels, iterations))


def update_convs(filters, obs_channels, policy_channels, iterations, n, k):
    """[(Cin, Cout, pass)] of the hex convs one learner update needs, pass
    in ("forward", "dx", "dw"): the full forward at ``iterations`` with its
    backward (dX for every conv but the stem, whose input is the
    observation; dW for every conv), then, with the progressive loss's draws
    (n, k), a forward of n + k iterations whose thought is detached at
    iteration n (none where n is 0) and the backward that reaches past the
    detach: the k iterations after it and the heads."""
    full = evaluation_convs(filters, obs_channels, policy_channels, iterations)
    out = [(i, o, "forward") for i, o in full]
    out += [(i, o, "dw") for i, o in full] + [(i, o, "dx") for i, o in full[1:]]
    prog = evaluation_convs(filters, obs_channels, policy_channels, n + k)
    out += [(i, o, "forward") for i, o in prog]
    recall, block, heads = (filters + obs_channels, filters), (filters, filters), prog[-6:]
    if n == 0:
        out += [(i, o, "dw") for i, o in prog] + [(i, o, "dx") for i, o in prog[1:]]
    else:
        # Iterations n..n+k-1 (5 convs each) and the 6 head convs.  The first
        # conv of iteration n (the recall, on the detached thought and the
        # observation) takes no dX.
        tail = [recall] + [block] * 4
        live = tail * k + heads
        out += [(i, o, "dw") for i, o in live] + [(i, o, "dx") for i, o in live[1:]]
    return out


def work_flops(work: dict) -> float:
    """Operations of a stretch of work: ``work["convs"]`` lists (pixels, Cin,
    Cout, pass, count) of the hex convs it needs."""
    return sum(conv_flops(px, i, o) * n for px, i, o, _, n in work["convs"])


def work_bound_s(work: dict) -> float:
    """The least time the card could take for a stretch of work's hex convs."""
    return sum(bound_s(work["dtype"], px, i, o) * n for px, i, o, _, n in work["convs"])
