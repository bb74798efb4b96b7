"""Frozen copy of the port's SCS engine (``nuzero_tpu_torch/envs/scs``), the
plain reference of the self-play cells' env transitions."""
