"""Time builds of the bf16 hex-conv weight-gradient kernel against each
other on one card.

    python -m nuzero_tpu_torch.ops.cuda.tune_dw [--source NAME=PATH ...]
        [--unchecked NAME=PATH ...] [--batch 256] [--reps 20]

The first build is ``csrc/hexconv_dw.cu`` as it stands (``tree``); each
``--source`` adds another ``hexconv_dw.cu`` with the same C interface (an
edited copy, or an older tree's); each ``--unchecked`` one that is timed
but not checked (a diagnostic build that leaves part of the work out, to
see what that part costs).  All are built at once and launched with
the tree's grid plan (``dw_plan``); each is checked against
``hex_conv_dw_plain`` (1e-2 of max|dW|: one bf16 rounding of f32 sums in
another order) at the 256-filter update's shapes at B=8 and at
``measure.BACKWARD_RAGGED``, then timed at the update's shapes (``--batch``,
5x5 boards, 4 iterations) in turns (v1, v2, ..., v2, v1) with CUDA events,
as a loop of calls and as one replayed CUDA graph of the same calls, and
splits each build's device time under ``torch.profiler`` into the main
kernel and the reduce kernel that adds the slices.  Beside them it times,
as the yardstick, cuDNN's weight-grad of the dual 3x3 conv
(``measure.library_backward``, graph-timed).  It prints one line per shape
and the sums per update.
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


def _call(lib, x, dy):
    B, H, W, cin = x.shape
    cout = dy.shape[3]
    slices, per = dw_plan(B * H * W, cin, cout, torch.bfloat16, x.device.index)
    part = torch.empty(slices, 7 * cin, cout, device=x.device)
    dw = torch.empty(7, cin, cout, dtype=x.dtype, device=x.device)
    err = lib.hexconv_dw(x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), B, H, W,
                         cin, cout, 1, slices, per,
                         torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"hexconv_dw failed: CUDA error {err}")
    return dw


def _split(fn, reps):
    """Device ms per call of ``fn`` in the main kernel and in the reduce
    kernel, from the profiler's kernel events over ``reps`` calls."""
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
    ms = {"main": 0.0, "reduce": 0.0}
    for e in events:
        if e.get("cat") == "kernel" and "hexconv_dw" in e["name"]:
            ms["reduce" if "reduce" in e["name"] else "main"] += e["dur"] / 1e3 / reps
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--unchecked", action="append", default=[])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_dw: no CUDA device available", file=sys.stderr)
        return 1

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
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).to(torch.bfloat16)
        dy = torch.randn(b, h, w, cout, device="cuda", generator=gen).to(torch.bfloat16)
        return x, dy

    shapes = conv_shapes(256, iterations=TRAIN_ITERS)
    checks = [(8, 5, 5, cin, cout) for cin, cout, _ in shapes] + list(BACKWARD_RAGGED)
    for shape in checks:
        x, dy = inputs(*shape)
        ref = hex_conv_dw_plain(x, dy).float()
        tol = 1e-2 * ref.abs().max().item()
        for name, lib in zip(names[:checked], libs):
            err = (_call(lib, x, dy).float() - ref).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} {shape}: max abs err {err} > {tol}")
    print(f"{', '.join(names[:checked])} match hex_conv_dw_plain at {len(checks)} shapes",
          flush=True)

    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    sums = {name: [0.0, 0.0] for name in names}
    lib_sum = bound_sum = 0.0
    for cin, cout, count in shapes:
        x, dy = inputs(args.batch, 5, 5, cin, cout)
        w = torch.randn(7, cin, cout, device="cuda", generator=gen).to(torch.bfloat16)
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
            cells.append(f"{name} {lm:.4f} / {gm:.4f} (main {split['main']:.4f}, reduce "
                         f"{split['reduce']:.4f})")
        library = graph_ms(library_backward(x, w, dy)[1], args.reps)
        b_ms, _ = bound("bfloat16", args.batch, 5, 5, cin, cout)
        lib_sum += count * library
        bound_sum += count * b_ms
        print(f"bf16 dW B={args.batch} 5x5 {cin}->{cout} (x{count}), ms loop / graph "
              "(profiled device ms): "
              + ", ".join(cells) + f"; cuDNN wgrad {library:.4f}; bound {b_ms:.4f}  [{card}]",
              flush=True)
    for name in names:
        print(f"per 256f update, {name}: loop {sums[name][0]:.4f} ms, graph {sums[name][1]:.4f} "
              f"ms, {100 * bound_sum / sums[name][1]:.1f}% of bound  [{card}]")
    print(f"per 256f update, cuDNN wgrad {lib_sum:.4f} ms, bound {bound_sum:.4f} ms  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
