"""The share of the arena window in which no operation ran on the card, in %
(``harness.idle_pct``)."""

from cardbench import harness


def read(ctx):
    return harness.idle_pct(ctx)
