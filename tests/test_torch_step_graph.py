"""The counters and the overflow flags of the port's bounded loops.

``profiling.count`` adds calls and no time (the SCS env's step counts its
path with it), and ``graphs.overflow_into`` names the bounds recorded into
its flag (the text of a captured move's ``OverflowError``).  This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_step_graph.py --noconftest -q
"""

import torch

from nuzero_tpu_torch.utils import graphs, profiling


def test_counts_add_calls_and_no_time():
    """A count inside a span adds a call and no time, and takes nothing
    from the span's self time; under a profiler it is left out, as a span
    is."""
    profiling.reset()
    with profiling.span("outer"):
        for _ in range(3):
            profiling.count("inner")
    snap = profiling.snapshot()
    assert snap["inner"] == {"calls": 3, "total_s": 0.0, "self_s": 0.0}
    assert snap["outer"]["self_s"] == snap["outer"]["total_s"] > 0
    with torch.profiler.profile():
        profiling.count("inner")
    assert profiling.snapshot()["inner"]["calls"] == 3


def test_overflow_into_names_the_bounds_it_collects():
    """``overflow_into`` yields the bounds recorded into its flag: the
    message a graph's overflow raises."""
    flag = torch.zeros((), dtype=torch.bool)
    with graphs.overflow_into(flag) as whats:
        graphs.overflowed(torch.tensor(False), "a loop's 3 trips")
        graphs.overflowed(torch.tensor(True), "another loop's 2 trips")
    assert whats == ["a loop's 3 trips", "another loop's 2 trips"]
    assert bool(flag)
