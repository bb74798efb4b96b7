"""Time builds of the f32 hex-conv kernel against each other on one card.

    python -m nuzero_tpu_torch.ops.cuda.tune_f32 [--source NAME=PATH ...]
        [--batch 512] [--reps 50]

The first build is ``csrc/hexconv.cu`` as it stands (``tree``); each
``--source`` adds another ``hexconv.cu`` with the same C interface (an edited
copy, or an older tree's).  All are built at once; each is checked against
``hex_conv_plain`` (1e-4 of max|y|) at the 64-filter leg's shapes at B=8 and
at ``measure.RAGGED``, then timed at the leg's shapes (``--batch``, 5x5
boards) in turns (v1, v2, ..., v2, v1) with CUDA events, both as a loop of
launches (what the self-play move sees) and as one replayed CUDA graph of
the same launches (device time without the host's launch rate).  Beside
them it times, as a yardstick, cuBLAS's f32 GEMM (TF32 off) of the same
product with A already gathered, ``[M, 7 Cin] x [7 Cin, Cout]`` (``gemm``,
graph-timed).  It prints one line per shape and the sums per network
evaluation.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from nuzero_tpu_torch.ops.cuda.build import hexconv_library
from nuzero_tpu_torch.ops.cuda.measure import (
    RAGGED, bound, card_line, conv_shapes, graph_ms, time_ms,
)
from nuzero_tpu_torch.ops.hexconv import hex_conv_plain


def _call(lib, x, w):
    y = torch.empty(*x.shape[:3], w.shape[2], device=x.device)
    err = lib.hexconv_forward(x.data_ptr(), w.data_ptr(), y.data_ptr(), *x.shape,
                              w.shape[2], 0, torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"hexconv_forward failed: CUDA error {err}")
    return y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_f32: no CUDA device available", file=sys.stderr)
        return 1

    specs = [("tree", "hexconv.cu")]
    for item in args.source:
        name, path = item.split("=", 1)
        specs.append((name, os.path.abspath(path)))
    with ThreadPoolExecutor(len(specs)) as pool:
        libs = list(pool.map(lambda s: hexconv_library(s[1]), specs))
    names = [s[0] for s in specs]
    card = card_line()
    print(card, flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, h, w, cin, cout):
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen)
        wt = torch.randn(7, cin, cout, device="cuda", generator=gen) / (7 * cin) ** 0.5
        return x, wt

    checks = [(8, 5, 5, cin, cout) for cin, cout, _ in conv_shapes(64)] + list(RAGGED)
    for shape in checks:
        x, wt = inputs(*shape)
        ref = hex_conv_plain(x, wt)
        tol = 1e-4 * ref.abs().max().item()
        for name, lib in zip(names, libs):
            err = (_call(lib, x, wt) - ref).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} {shape}: max abs err {err} > {tol}")
    print(f"all builds match hex_conv_plain at {len(checks)} shapes")

    torch.backends.cuda.matmul.allow_tf32 = False
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    sums = {name: [0.0, 0.0] for name in names}
    gemm_sum = 0.0
    for cin, cout, count in conv_shapes(64):
        x, wt = inputs(args.batch, 5, 5, cin, cout)
        loop = {name: [] for name in names}
        graph = {name: [] for name in names}
        for i in order:
            fn = (lambda lib: lambda: _call(lib, x, wt))(libs[i])
            loop[names[i]].append(time_ms(fn, args.reps))
            graph[names[i]].append(graph_ms(fn, args.reps))
        cells = []
        for name in names:
            lm, gm = sum(loop[name]) / len(loop[name]), sum(graph[name]) / len(graph[name])
            sums[name][0] += count * lm
            sums[name][1] += count * gm
            cells.append(f"{name} {lm:.4f} / {gm:.4f}")
        a = torch.randn(x.shape[0] * 25, 7 * cin, device="cuda", generator=gen)
        gemm = graph_ms(lambda: a @ wt.reshape(7 * cin, cout), args.reps)
        gemm_sum += count * gemm
        b_ms, _ = bound("float32", args.batch, 5, 5, cin, cout)
        print(f"f32 B={args.batch} 5x5 {cin}->{cout} (x{count}), ms loop / graph: "
              + ", ".join(cells) + f"; gemm {gemm:.4f}; bound {b_ms:.4f}  [{card}]")
    for name in names:
        print(f"per 64f evaluation, {name}: loop {sums[name][0]:.4f} ms, "
              f"graph {sums[name][1]:.4f} ms  [{card}]")
    print(f"per 64f evaluation, cuBLAS gemm of the gathered A: {gemm_sum:.4f} ms  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
