"""Per-block timeline of the f32 hex-conv weight-gradient kernel on one card.

    python -m nuzero_tpu_torch.ops.cuda.timeline_dw [--batch 256]
        [--shape CIN,COUT ...]

Builds an instrumented copy of ``csrc/hexconv_dw.cu`` in which thread 0 of
every block of the f32 kernel reads ``%globaltimer`` and ``clock64`` at the
block's phases (``PHASES``): start, first chunk landed, main loop done,
the groups' tiles added, the cluster's first barrier passed, the block's
share of the cluster sum added and stored, the last barrier passed.  It
runs the call once at B=``--batch`` on 5x5 boards per shape (by default
the 64-filter update's 64->64, 150->64 and 16->1), with the tree's grid
plan, and prints per phase the median and largest time over the blocks
and the SM clock.  The instrumented library is built beside the others in
``_build/``; the tree's kernel is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch

from nuzero_tpu_torch.ops.cuda.build import BUILD_DIR, CSRC, hexconv_dw_library
from nuzero_tpu_torch.ops.cuda.hexconv_kernel import dw_plan
from nuzero_tpu_torch.ops.cuda.measure import card_line

#: The phases between consecutive marks, in order.
PHASES = ("first chunk", "main loop", "groups' sum", "cluster barrier", "share sum + store",
          "last barrier")
SLOTS = 16  # u64 per block: (globaltimer, clock64) per mark, then the SM id

_MARK = r'''
__device__ unsigned long long* g_timeline = nullptr;
__device__ __forceinline__ void mark(int k) {
  if (g_timeline && threadIdx.x == 0) {
    const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    unsigned long long t, sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_timeline[b * 16 + 2 * k] = t;
    g_timeline[b * 16 + 2 * k + 1] = clock64();
    asm volatile("{ .reg .u32 s; mov.u32 s, %%smid; cvt.u64.u32 %0, s; }" : "=l"(sm));
    g_timeline[b * 16 + 15] = sm;
  }
}
'''

# (anchor, text put before it, text put after it): each anchor must occur
# in csrc/hexconv_dw.cu exactly once.
_EDITS = (
    ("namespace f32 {\n", _MARK, ""),
    ("  const int W = p.W;\n", "", "  mark(0);\n"),
    ("    // Group g takes", "    if (c == 0) mark(1);\n", ""),
    ("  // Epilogue.", "  mark(2);\n", ""),
    ("  namespace cg = cooperative_groups;", "  mark(3);\n", ""),
    ("  if (csize > 1) cluster.sync(); else __syncthreads();\n", "", "  mark(4);\n"),
    ("  if (csize > 1) cluster.sync();  // no block leaves", "  mark(5);\n", ""),
)


def instrument(source: str) -> str:
    """``source`` (the text of ``csrc/hexconv_dw.cu``) with the marks and
    an ``extern "C" set_timeline(ptr)``; raises if an anchor moved."""
    for anchor, before, after in _EDITS:
        if source.count(anchor) != 1:
            raise ValueError(f"timeline anchor not found once in hexconv_dw.cu: {anchor!r}")
        source = source.replace(anchor, before + anchor + after)
    end = source.index("\n", source.index("  if (csize > 1) cluster.sync();  // no block leaves"))
    source = source[:end + 1] + "  mark(6);\n" + source[end + 1:]
    return source + '''
extern "C" int set_timeline(unsigned long long* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_timeline, &p, sizeof(p)));
}
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--shape", action="append", default=[],
                    help="CIN,COUT (default: 64,64 150,64 16,1)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("timeline_dw: no CUDA device available", file=sys.stderr)
        return 1
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shape] or [
        (64, 64), (150, 64), (16, 1)]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "hexconv_dw_timeline.cu")
    with open(os.path.join(CSRC, "hexconv_dw.cu")) as f:
        text = instrument(f.read())
    with open(path, "w") as f:
        f.write(text)
    lib = hexconv_dw_library(path)
    lib.set_timeline.argtypes = [ctypes.c_void_p]
    card = card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, W = args.batch, 5, 5
    for cin, cout in shapes:
        x = torch.randn(B, H, W, cin, device="cuda", generator=gen)
        dy = torch.randn(B, H, W, cout, device="cuda", generator=gen)
        slices, per, _ = dw_plan(B * H * W, cin, cout, torch.float32, x.device.index, W, lib)
        part = torch.empty(slices, 7 * cin, cout, device="cuda")
        dw = torch.empty(7, cin, cout, device="cuda")
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)

        def call():
            err = lib.hexconv_dw(x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                 B, H, W, cin, cout, 0, slices, per, stream)
            if err != 0:
                raise RuntimeError(f"hexconv_dw failed: CUDA error {err}")

        for _ in range(3):
            call()
        blocks = lib.hexconv_dw_blocks_per_slice(cin, cout, 0) * slices
        marks = torch.zeros(blocks * SLOTS, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        lib.set_timeline(marks.data_ptr())
        call()
        torch.cuda.synchronize()
        lib.set_timeline(None)
        t = marks.view(-1, SLOTS).cpu()
        t = t[t[:, 0] > 0].double()
        print(f"f32 dW B={B} 5x5 {cin}->{cout}: {t.shape[0]} blocks on "
              f"{len(set(t[:, 15].tolist()))} SMs, {slices} slices of {per} pixels  [{card}]")
        for k, name in enumerate(PHASES):
            us = (t[:, 2 * k + 2] - t[:, 2 * k]) / 1e3
            ghz = (t[:, 2 * k + 3] - t[:, 2 * k + 1]) / (t[:, 2 * k + 2] - t[:, 2 * k]).clamp(min=1)
            print(f"  {name:18s} us: median {us.median():.2f}, max {us.max():.2f} "
                  f"(SM clock {ghz.median():.3f} GHz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
