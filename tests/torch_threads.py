"""One torch CPU thread in each test process of the port's tests.

The suite runs under pytest-xdist with several workers on a machine of a
few cores. torch's default, an OpenMP thread per core in every worker,
puts several times more spinning threads than cores on the machine, and
that slowed the port's small-tensor tests 5-20x (6 workers on 8 cores: the
whole suite took 1218 s, and 313-484 s with one thread a process, the same
tests passing). Each tests/test_torch_*.py that runs torch on the CPU
imports this module, so a worker that collects any of them runs torch on
one thread; a file run alone does too. The rank processes of
tests/torch_rank_worker.py get the same through OMP_NUM_THREADS.
"""

import torch

torch.set_num_threads(1)
