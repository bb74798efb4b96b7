"""The learner window's share of the card's peak, in % (``harness.mfu_pct``)."""

from cardbench import harness


def read(ctx):
    return harness.mfu_pct(ctx)
