"""Plain references of the benchmark: plain PyTorch and NumPy, computed in
float32 with TF32 off.  Nothing here imports the port, the JAX package or
JAX."""
