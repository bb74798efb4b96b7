"""Device operations per self-play move in the traced stretch (graphed move:
``training/selfplay.py``, ``utils/graphs.py``)."""

from cardbench import harness


def read(ctx):
    return harness.kernels_per_unit(ctx)
