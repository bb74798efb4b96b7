"""The hex-conv kernels' share of their roofline in the traced stretch of
the selfplay cell, in % (``harness.roofline_pct``)."""

from cardbench import harness


def read(ctx):
    return harness.roofline_pct(ctx)
