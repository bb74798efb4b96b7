"""Run one cell of the benchmark once on the card(s) of this machine.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  The cell's
configuration (``cardbench/configs/<config>.json``), traffic mix
(``cardbench/traffic/<traffic>.json``, read by the driver of its ``kind``,
``cardbench/drivers/<kind>.py``) and limits (``cardbench/limits/<cell>.json``)
are found by name; so are the per-layer metrics of a ``--trace 1`` run
(``cardbench/metrics/<metric>.py``).  The run builds its inputs and weights
from ``--seed``, warms up (set-up), measures ``--seconds`` seconds, then
judges what the timed path produced against the plain reference
(``cardbench/reference/``).  The comparisons are the last lines of standard
error; the result is the last line of standard output.  With no card, or
fewer than the cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cardbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_dirs()
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cardbench: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(f"cardbench.drivers.{cell.traffic['kind']}")
    out = driver.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=torch.device("cuda", 0), t_start=T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"cardbench: the run loaded {', '.join(found)}; the benchmark runs the "
              "PyTorch port alone", file=sys.stderr)
        return 3
    result = {"correct": all(c.ok for c in out.checks), "attempted": out.attempted,
              "failed": out.failed}
    if args.trace:
        result["metrics"] = harness.per_layer_metrics(cell, out.context)
    else:
        result["metrics"] = out.end_to_end
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes,
                        "card": harness.card_line()}
    if args.trace:
        trace = out.context["trace"]
        result["device"].update(busy_s=trace["busy_s"], window_s=trace["wall_s"])
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    harness.emit(result, out.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
