"""The overflow flags of the port's bounded loops: ``graphs.overflow_into``
names the bounds recorded into its flag (the text of a captured move's
``OverflowError``).  This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_step_graph.py --noconftest -q
"""

import torch

from nuzero_tpu_torch.utils import graphs


def test_overflow_into_names_the_bounds_it_collects():
    """``overflow_into`` yields the bounds recorded into its flag: the
    message a graph's overflow raises."""
    flag = torch.zeros((), dtype=torch.bool)
    with graphs.overflow_into(flag) as whats:
        graphs.overflowed(torch.tensor(False), "a loop's 3 trips")
        graphs.overflowed(torch.tensor(True), "another loop's 2 trips")
    assert whats == ["a loop's 3 trips", "another loop's 2 trips"]
    assert bool(flag)
