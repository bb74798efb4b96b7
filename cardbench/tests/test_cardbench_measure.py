"""The yardstick's counts against hand counts."""

import pytest

from cardbench.reference import measure

# Hand counts of Cin*Cout summed over one evaluation's hex convs at 4
# iterations: stem, 4 recalls, 16 block convs, the policy ramp, the value ramp.
EVAL_256 = (86 * 256 + 4 * 342 * 256 + 16 * 256 * 256 + 256 * 138 + 138 * 21
            + 256 * 192 + 192 * 128 + 128 * 64 + 64 * 1)
EVAL_64 = (67 * 64 + 4 * 131 * 64 + 16 * 64 * 64 + 64 * 38 + 38 * 12
           + 64 * 48 + 48 * 32 + 32 * 16 + 16 * 1)


def test_ramps_match_the_nets_heads():
    assert measure.ramp(256, 21, 2) == [138, 21]
    assert measure.ramp(256, 1, 4) == [192, 128, 64, 1]
    assert measure.ramp(64, 12, 2) == [38, 12]
    assert measure.ramp(64, 1, 4) == [48, 32, 16, 1]


@pytest.mark.parametrize("filters,obs,planes,pixels,hand", [
    (256, 86, 21, 512 * 25, EVAL_256),
    (64, 67, 12, 128 * 25, EVAL_64),
])
def test_evaluation_flops(filters, obs, planes, pixels, hand):
    assert EVAL_256 == 1541010 and EVAL_64 == 111384
    assert measure.evaluation_flops(pixels, filters, obs, planes, 4) == 14 * pixels * hand
    assert len(measure.evaluation_convs(filters, obs, planes, 4)) == 27


def test_bound_of_one_conv_by_hand():
    # bf16 256 -> 256 at B=512, 5x5: 1.1744e10 operations at 989 TFLOP/s
    # (11.874 us) against 14,024,704 bytes at 3.35 TB/s (4.19 us).
    ops = 2 * 7 * 12800 * 256 * 256
    nbytes = (12800 * 256 + 7 * 256 * 256 + 12800 * 256) * 2
    assert measure.conv_flops(12800, 256, 256) == ops
    assert measure.conv_bytes("bfloat16", 12800, 256, 256) == nbytes == 14024704
    assert measure.bound_s("bfloat16", 12800, 256, 256) == pytest.approx(ops / 989e12)
    # f32 64 -> 1 at B=128: bound by bytes.
    nbytes = (3200 * 64 + 7 * 64 + 3200) * 4
    assert measure.bound_s("float32", 3200, 64, 1) == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("filters,obs,planes", [(256, 86, 21), (64, 67, 12)])
@pytest.mark.parametrize("n,k,fwd,dx,dw", [
    (0, 4, 27 + 27, 26 + 26, 27 + 27),   # no detach: the whole second forward
    (1, 2, 27 + 22, 26 + 15, 27 + 16),   # detached at 1: 2 iterations and the heads
    (3, 1, 27 + 27, 26 + 10, 27 + 11),
])
def test_update_convs_by_hand(filters, obs, planes, n, k, fwd, dx, dw):
    convs = measure.update_convs(filters, obs, planes, 4, n, k)
    count = {p: sum(1 for *_, q in convs if q == p) for p in ("forward", "dx", "dw")}
    assert count == {"forward": fwd, "dx": dx, "dw": dw}
    # Each pass of a conv moves and computes the same as its forward.
    full = sum(measure.conv_flops(1, i, o) for i, o, q in convs if q == "forward")
    assert full == pytest.approx(14 * (EVAL_256 if filters == 256 else EVAL_64)
                                 + sum(measure.conv_flops(1, i, o) for i, o in
                                       measure.evaluation_convs(filters, obs, planes, n + k)))


def test_work_sums():
    work = {"dtype": "float32", "convs": [(3200, 64, 64, "forward", 10), (3200, 64, 1, "dw", 2)]}
    assert measure.work_flops(work) == 10 * 14 * 3200 * 4096 + 2 * 14 * 3200 * 64
    assert measure.work_bound_s(work) == pytest.approx(
        10 * measure.bound_s("float32", 3200, 64, 64) + 2 * measure.bound_s("float32", 3200, 64, 1))


@pytest.mark.parametrize("cell", ["selfplay.solo64", "learner.contested256",
                                  "arena.sweep64_s15"])
def test_every_per_layer_metric_reads_a_traced_run(cell):
    """Each reader that BENCHMARK.json (or ``later/``, for a cell kept for
    later) lists for a cell, found by name, on a traced run's context: a
    number where there is something to read."""
    from cardbench import harness

    work = {"dtype": "float32", "units": 10, "convs": [(128 * 25, 64, 64, "forward", 40)]}
    ctx = {"capture_s": 12.5, "window": dict(work, seconds=2.0),
           "traced": dict(work, units=1),
           "trace": {"kernels": 5000, "busy_s": 0.1, "hexconv_busy_s": 0.02, "wall_s": 0.3}}
    c = harness.find_cell(cell, spec=harness.spec_with_later())
    got = harness.per_layer_metrics(c, ctx)
    want = {m["name"] for m in c.spec["per_layer"] if cell in m["workloads"]}
    assert set(got) == want
    assert all(0 < v["value"] for v in got.values())
    bound = 100 * measure.work_bound_s(ctx["traced"]) / 0.02
    assert got.get(next(n for n in want if n.startswith("hexconv_roofline")))["value"] == (
        pytest.approx(bound))
    assert got[next(n for n in want if n.startswith("device_idle_pct"))]["value"] == (
        pytest.approx(100 * (1 - 0.1 / 0.2)))
