"""The plain reference of the benchmark's correctness check: float32
PyTorch on the published checkpoints' keys, importing nothing of the
program (seedvr2_tpu_torch) or of JAX."""
