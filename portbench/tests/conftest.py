"""The benchmark's CPU tests: torch on one thread a test process (the
suite runs under several pytest workers on a few cores)."""

import torch

torch.set_num_threads(1)
