"""The benchmark's general parts: finding a cell's files by name, drawing
weights from the seed, the traced window and its reduction, the checks and
the result line.  Nothing here imports the port at module level; the
drivers (``drivers/<kind>.py``) do, when a run starts.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "cardbench")
# Build and kernel caches of the program: fixed folders inside the checkout.
CACHE = os.path.join(ROOT, ".cardbench_cache")
#: Top-level module names that a run must not have loaded, compared whole
#: (the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "nuzero_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s workloads with its files."""

    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    spec: dict  # the whole BENCHMARK.json


def spec_with_later(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` with the entries of the cells kept for later
    (``cardbench/later/<cell>.json``: proved, but left out of the check)
    added, as a PR that brings such a cell back adds them."""
    spec = load_json(root, "BENCHMARK.json")
    folder = os.path.join(root, "cardbench", "later")
    for name in sorted(os.listdir(folder)):
        later = load_json(folder, name)
        for key in ("workloads", "end_to_end", "per_layer"):
            spec[key] = spec[key] + later[key]
    return spec


def find_cell(name: str, root: str = ROOT, spec: dict = None) -> Cell:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json`` where not given)."""
    spec = load_json(root, "BENCHMARK.json") if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    return Cell(name=name, config_name=w["config"], config=load_json(root, conf["file"]),
                traffic=load_json(root, "cardbench", "traffic", w["traffic"] + ".json"),
                limits=load_json(root, "cardbench", "limits", name + ".json"),
                chips=int(w["chips"]), spec=spec)


def traffic_file(*parts) -> dict:
    """A data file that a traffic mix names (scenarios, recipes)."""
    return load_json(HERE, "traffic", *parts)


def set_cache_dirs() -> None:
    """Point the program's kernel caches into the checkout (fixed paths)."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def draw_params(module, seed: int, device):
    """Fresh f32 parameters of ``module`` under its own names, drawn on the
    device from ``seed`` in one call: uniform in (-1, 1), each hex-conv
    weight [7, Cin, Cout] scaled to the port's initializer's bound
    sqrt(1 / (7 * Cin)) (variance_scaling(1/3, fan_in, uniform))."""
    import torch

    named = list(module.named_parameters())
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, p in named:
        if p.dim() != 3 or p.shape[0] != 7:
            raise ValueError(f"draw_params: {name} {tuple(p.shape)} is no hex-conv weight")
        n = p.numel()
        out[name] = (flat[at:at + n].view(p.shape) * (1.0 / (7 * p.shape[1])) ** 0.5).clone()
        at += n
    for name, b in module.named_buffers():
        out[name] = b.detach().clone()
    return out


# -- traced window -----------------------------------------------------------

def profile(fn):
    """``fn()`` under torch.profiler -> (fn's result, trace dict): device
    kernels ``(name, start_us, dur_us)``, host operations likewise, and the
    wall seconds of the traced stretch (host clock, ended by a synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        result = fn()
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            start, dur = float(e.start_us()), float(e.duration_us())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name(), start, dur))
        else:
            host.append((e.name(), start, dur))
    return result, {"kernels": kernels, "host": host, "wall_s": wall}


def union_us(intervals) -> float:
    """Microseconds covered by the union of (start, dur) intervals."""
    busy, end = 0.0, float("-inf")
    for start, dur in sorted(intervals):
        stop = start + dur
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def is_hexconv(name: str) -> bool:
    return "hexconv" in name


def summarize(trace: dict) -> dict:
    """Busy seconds, hex-conv busy seconds, kernel count, the ten device
    operations that took most time, and the ten longest idle stretches
    between kernels by the innermost host operation open at their start."""
    kernels = sorted(trace["kernels"], key=lambda k: k[1])
    busy = union_us((s, d) for _, s, d in kernels) / 1e6
    hex_busy = union_us((s, d) for n, s, d in kernels if is_hexconv(n)) / 1e6
    by_name = collections.Counter()
    for n, _, d in kernels:
        by_name[n[:120]] += d / 1e6
    host = sorted(trace["host"], key=lambda h: h[1])
    gaps = collections.Counter()
    end = kernels[0][1] + kernels[0][2] if kernels else 0.0
    starts = [h[1] for h in host]
    for name, s, d in kernels[1:]:
        if s > end:
            gap = s - end
            # The innermost host operation open at the gap's start: the
            # latest-starting one that still runs then.
            label = "host: between operations"
            i = bisect.bisect_right(starts, end)
            for h in reversed(host[max(0, i - 400):i]):
                if h[1] + h[2] >= end:
                    label = "host: " + h[0][:100]
                    break
            gaps[label] += gap / 1e6
        end = max(end, s + d)
    return {"busy_s": busy, "hexconv_busy_s": hex_busy, "kernels": len(kernels),
            "wall_s": trace["wall_s"],
            "device_ops": [[n, v] for n, v in by_name.most_common(10)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(10)]}


# -- per-layer metrics --------------------------------------------------------

def per_layer_metrics(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric of BENCHMARK.json that this cell reports, read by
    its own module ``metrics/<name>.py``; a reader that finds nothing to read
    returns None and the metric is left out."""
    reported = {m["name"] for m in cell.spec["end_to_end"]
                if "workloads" not in m or cell.name in m["workloads"]}
    out = {}
    for m in cell.spec["per_layer"]:
        listed = m.get("workloads")
        if listed is not None and cell.name not in listed:
            continue
        if listed is None and m["moves"] not in reported:
            continue
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("cardbench_metric_" + m["name"], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {m['name']} read {value}")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# -- what the per-layer metrics read (``metrics/<name>.py``) -----------------

def idle_pct(ctx: dict):
    """The share of the window in which no operation ran on the card, in %:
    one minus the device-busy seconds per unit of work (move, update, arena
    move) in the traced stretch (the union of the device operations'
    intervals) over the host seconds per unit of the untraced window.  The
    traced stretch's own wall clock would count the profiler's buffer
    flushes as idle."""
    trace = ctx.get("trace", {})
    if not trace.get("kernels") or not ctx["window"]["units"]:
        return None
    busy = trace["busy_s"] / ctx["traced"]["units"]
    wall = ctx["window"]["seconds"] / ctx["window"]["units"]
    return 100.0 * (1.0 - busy / wall)


def roofline_pct(ctx: dict):
    """The hex-conv kernels' share of their roofline in the traced stretch:
    the least time the card could take for the convs that the work needs
    (each counted from the work, not from the launches;
    ``reference/measure.py``) over the device time of the kernels whose
    name holds ``hexconv``, in %."""
    from cardbench.reference import measure

    busy = ctx.get("trace", {}).get("hexconv_busy_s", 0.0)
    if busy <= 0:
        return None
    return 100.0 * measure.work_bound_s(ctx["traced"]) / busy


def mfu_pct(ctx: dict):
    """The window's share of the card's peak: the operations that the
    window's work needs (its hex convs; ``reference/measure.py``) over the
    window's seconds, against the configuration's peak (989 TFLOP/s bf16,
    67 TFLOP/s f32 without TF32), in %."""
    from cardbench.reference import measure

    w = ctx["window"]
    if not w["units"]:
        return None
    return 100.0 * measure.work_flops(w) / w["seconds"] / measure.PEAK_FLOPS[w["dtype"]]


def kernels_per_unit(ctx: dict):
    """Device operations per unit of the traced work (move, update)."""
    if not ctx.get("trace", {}).get("kernels"):
        return None
    return ctx["trace"]["kernels"] / ctx["traced"]["units"]


# -- checks and the result line ---------------------------------------------

@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    at_most: bool = True  # the value may not pass the limit upward

    @property
    def ok(self) -> bool:
        if not math.isfinite(self.value):
            return False
        return self.value <= self.limit if self.at_most else self.value >= self.limit

    def line(self) -> str:
        rel = "<=" if self.at_most else ">="
        return (f"check {self.name} = {self.value!r} (limit {rel} {self.limit!r}) "
                f"{'ok' if self.ok else 'FAILED'}")

    def entry(self) -> dict:
        return {"value": self.value, "limit": self.limit,
                "must_be": "at_most" if self.at_most else "at_least"}


def emit(result: dict, checks: list) -> None:
    """The comparisons as the last lines of standard error, then the result
    as one JSON line on standard output, ``checks`` its last key."""
    for c in checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {c.name: c.entry() for c in checks}
    print(json.dumps(result))
    sys.stdout.flush()
