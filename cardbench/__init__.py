"""The benchmark of the PyTorch and CUDA port (``nuzero_tpu_torch``) on the
card: ``python3 cardbench/run.py --workload <cell> ...``."""
