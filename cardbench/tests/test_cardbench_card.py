"""One run of a cell on the card, through the command the driver runs: it
prints a correct result with every metric the cell reports."""

import json
import os
import subprocess
import sys

import pytest

from cardbench import harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(cuda_card, trace):
    cell = "arena.sweep64_s15"
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 11 + trace), "--seconds", "5",
                          "--trace", str(trace)], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    if trace:
        want = {m["name"] for m in spec["per_layer"] if cell in m.get("workloads", [cell])}
        assert result["device"]["busy_s"] > 0 and "breakdown" in result
    else:
        want = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want
