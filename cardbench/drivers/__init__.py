"""One driver per kind of traffic mix (``kind`` in ``traffic/<mix>.json``):
``run(cell, seed, seconds, trace, device, t_start) -> common.Outcome``."""
