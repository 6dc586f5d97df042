"""The benchmark of the PyTorch + CUDA port (seedvr2_tpu_torch): one cell
a run, ``python -m portbench.run``; see README.md."""
