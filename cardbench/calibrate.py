"""Readings that the limits of ``limits/<cell>.json`` are set from: the
program's over many seeds and the control's (the plain reference one
precision below the configuration's, in the program's place) on the same
outputs, in one process.

    python3 cardbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 5 \\
        [--out chiprun_out/calibrate.jsonl]

A cell kept for later (``cardbench/later/``) is calibrated as well.
One JSON line per seed: the program's readings, the control's (and a
learner cell's planted faults') with whether each passes the cell's own
checks (``control_correct``: false where the checks catch it), and the
end-to-end metrics of the short window.  The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cardbench import harness  # noqa: E402
from cardbench.drivers import common  # noqa: E402

#: The control of each configuration's precision: the nearest one below.
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.find_cell(args.workload, spec=harness.spec_with_later())
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    driver = importlib.import_module(f"cardbench.drivers.{cell.traffic['kind']}")
    control = CONTROL[cell.config["compute_dtype"]]
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res = driver.run(cell, seed=seed, seconds=args.seconds, trace=False,
                         device=torch.device("cuda", 0), t_start=t0, control=control)
        others = {k: v for k, v in res.context.items()
                  if k == "control" or k.startswith("fault_")}
        line = json.dumps({"cell": cell.name, "seed": seed, "control_precision": control,
                           "program": res.context["readings"], **others,
                           "checks_ok": all(c.ok for c in res.checks),
                           # Each other reading through the cell's own checks:
                           # false where a check catches it.
                           **{f"{k}_correct": all(c.ok for c in
                                                  driver.compare(v, cell.limits))
                              for k, v in others.items()},
                           "metrics": res.end_to_end, "run_s": time.perf_counter() - t0},
                          default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del res
        common.release(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
