"""Device operations per learner update in the traced stretch (forward,
backward and Adam: ``training/learner.py``, ``losses.py``, ``replay.py``)."""

from cardbench import harness


def read(ctx):
    return harness.kernels_per_unit(ctx)
