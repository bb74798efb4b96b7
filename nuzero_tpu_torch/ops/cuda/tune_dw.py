"""Time builds of a hex-conv weight-gradient kernel against each other on
one card.

    python -m nuzero_tpu_torch.ops.cuda.tune_dw [--dtype bfloat16|float32]
        [--source NAME=PATH ...] [--unchecked NAME=PATH ...] [--batch 256]
        [--reps 20]

The first build is ``csrc/hexconv_dw.cu`` as it stands (``tree``); each
``--source`` adds another ``hexconv_dw.cu`` with the same C interface (an
edited copy, or an older tree's); each ``--unchecked`` one that is timed
but not checked (a diagnostic build that leaves part of the work out, to
see what that part costs).  All are built at once and launched with
their own grid plans (``dw_plan`` on each build's tile rule and
occupancy) and a workspace of one partial per slice, which any plan
fits.  ``--dtype`` picks the kernel: bf16 at
the 256-filter update's shapes (the flagship), f32 at the 64-filter
update's (``scs_small.yaml``'s width).  Each build is checked against
``hex_conv_dw_plain`` (bf16: 1e-2 of max|dW|, one bf16 rounding of f32 sums
in another order; f32: 1e-5, f32 sums in another order) at the update's
shapes at B=8 and at ``measure.BACKWARD_RAGGED``, then timed at the
update's shapes (``--batch``, 5x5 boards, 4 iterations) in turns (v1, v2,
..., v2, v1) with CUDA events, as a loop of calls and as one replayed CUDA
graph of the same calls, and splits each build's device time under
``torch.profiler``: the main kernel alone, and with the reduce kernel that
adds the partials (the union of their intervals).  Beside them it times, as the yardstick, cuDNN's
weight-grad of the dual 3x3 conv (``measure.library_backward``, TF32 off,
loop and graph), and prints the workspace the tree's plan writes.  It
prints one line per shape and the sums per update.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from nuzero_tpu_torch.ops.cuda.build import hexconv_dw_library
from nuzero_tpu_torch.ops.cuda.hexconv_kernel import dw_plan
from nuzero_tpu_torch.ops.cuda.measure import (
    BACKWARD_RAGGED, TRAIN_ITERS, bound, card_line, conv_shapes, graph_ms, library_backward,
    time_ms,
)
from nuzero_tpu_torch.ops.hexconv import hex_conv_dw_plain


_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _call(lib, x, dy):
    B, H, W, cin = x.shape
    cout = dy.shape[3]
    slices, per, _ = dw_plan(B * H * W, cin, cout, x.dtype, x.device.index, W, lib)
    part = torch.empty(slices, 7 * cin, cout, device=x.device)
    dw = torch.empty(7, cin, cout, dtype=x.dtype, device=x.device)
    err = lib.hexconv_dw(x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), B, H, W,
                         cin, cout, _CODES[x.dtype], slices, per,
                         torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"hexconv_dw failed: CUDA error {err}")
    return dw


def _split(fn, reps):
    """Device ms per call of ``fn`` in the main kernel, and in the main and
    reduce kernels together (the union of their intervals: the f32 reduce
    kernel is a programmatic dependent launch that starts beside the main
    kernel's end), from the profiler's kernel events over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "hexconv_dw" in e["name"]]
    main = sum(e["dur"] for e in kernels if "reduce" not in e["name"])
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    total, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return {"main": main / 1e3 / reps, "all": total / 1e3 / reps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--unchecked", action="append", default=[])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_dw: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    filters = 256 if dtype == torch.bfloat16 else 64
    tag = f"{'bf16' if dtype == torch.bfloat16 else 'f32'} dW"

    specs = [("tree", "hexconv_dw.cu")]
    for item in args.source + args.unchecked:
        name, path = item.split("=", 1)
        specs.append((name, os.path.abspath(path)))
    checked = 1 + len(args.source)
    with ThreadPoolExecutor(len(specs)) as pool:
        libs = list(pool.map(lambda s: hexconv_dw_library(s[1]), specs))
    names = [s[0] for s in specs]
    card = card_line()
    print(card, flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, h, w, cin, cout):
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).to(dtype)
        dy = torch.randn(b, h, w, cout, device="cuda", generator=gen).to(dtype)
        return x, dy

    shapes = conv_shapes(filters, iterations=TRAIN_ITERS)
    checks = [(8, 5, 5, cin, cout) for cin, cout, _ in shapes] + list(BACKWARD_RAGGED)
    rel = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for shape in checks:
        x, dy = inputs(*shape)
        ref = hex_conv_dw_plain(x, dy).float()
        tol = rel * ref.abs().max().item()
        for name, lib in zip(names[:checked], libs):
            err = (_call(lib, x, dy).float() - ref).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} {shape}: max abs err {err} > {tol}")
    print(f"{', '.join(names[:checked])} match hex_conv_dw_plain at {len(checks)} shapes",
          flush=True)

    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    sums = {name: [0.0, 0.0] for name in names}
    lib_sum, bound_sum, workspace = [0.0, 0.0], 0.0, 0
    for cin, cout, count in shapes:
        x, dy = inputs(args.batch, 5, 5, cin, cout)
        w = torch.randn(7, cin, cout, device="cuda", generator=gen).to(dtype)
        partials = dw_plan(args.batch * 25, cin, cout, dtype, x.device.index, 5)[2]
        workspace += count * partials * 7 * cin * cout * 4
        loop = {name: [] for name in names}
        graph = {name: [] for name in names}
        for i in order:
            fn = (lambda lib: lambda: _call(lib, x, dy))(libs[i])
            loop[names[i]].append(time_ms(fn, args.reps))
            graph[names[i]].append(graph_ms(fn, args.reps))
        cells = []
        for name, lib in zip(names, libs):
            lm, gm = sum(loop[name]) / len(loop[name]), sum(graph[name]) / len(graph[name])
            sums[name][0] += count * lm
            sums[name][1] += count * gm
            split = _split(lambda: _call(lib, x, dy), args.reps)
            cells.append(f"{name} {lm:.4f} / {gm:.4f} (main {split['main']:.4f}, with reduce "
                         f"{split['all']:.4f})")
        wgrad = library_backward(x, w, dy)[1]
        library = (time_ms(wgrad, args.reps), graph_ms(wgrad, args.reps))
        b_ms, _ = bound(args.dtype, args.batch, 5, 5, cin, cout)
        lib_sum = [s + count * ms for s, ms in zip(lib_sum, library)]
        bound_sum += count * b_ms
        print(f"{tag} B={args.batch} 5x5 {cin}->{cout} (x{count}), ms loop / graph "
              "(profiled device ms): " + ", ".join(cells)
              + f"; cuDNN wgrad {library[0]:.4f} / {library[1]:.4f}; bound {b_ms:.4f}; tree "
              f"workspace {partials} x {7 * cin * cout * 4} B  [{card}]", flush=True)
    for name in names:
        print(f"per {filters}f update, {name}: loop {sums[name][0]:.4f} ms, graph "
              f"{sums[name][1]:.4f} ms, {100 * bound_sum / sums[name][1]:.1f}% of bound  [{card}]")
    print(f"per {filters}f update, cuDNN wgrad {lib_sum[0]:.4f} / {lib_sum[1]:.4f} ms, bound "
          f"{bound_sum:.4f} ms, tree workspace {workspace} B  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
