"""Joining a multi-process job, and which frames each process feeds
(counterpart of seedvr2_tpu/parallel/multihost.py).

The JAX package runs one SPMD program over a global mesh and assembles the
"data"-sharded segment batch from each host's local pieces
(``feed_host_segments``). In torch every rank is its own process with its
own segment: rank r feeds segment ``r // (seq * tensor)``, the data
coordinate of its mesh position (``local_data_coords``), and nothing is
assembled before the DiT; the segments' packed outputs are all-gathered
over the "data" group at the end (pipeline/multichip.py).

Started with torchrun, one process per card (README.md has a script):

    torchrun --nproc_per_node 4 upscale.py   # upscale.py calls initialize("nccl")
"""

from __future__ import annotations

import datetime
import os
from typing import Tuple

import torch
import torch.distributed as dist

from .mesh import AXIS_DATA, Mesh, make_mesh


def initialize(backend: str, timeout: datetime.timedelta = datetime.timedelta(minutes=10)) -> Tuple[int, int]:
    """Join the job that torchrun (or any launcher setting RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT) started. ``backend`` is the caller's
    choice: "nccl" for one rank per card, "gloo" for ranks that share a card
    or run on the CPU. ``timeout`` bounds every collective. Under NCCL the
    rank's card (LOCAL_RANK) becomes the current device first. Returns
    (rank, world size)."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"initialize: {missing} not set; start the ranks with torchrun")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, timeout=timeout)
    return rank, world


def global_data_mesh(seq: int = 1, tensor: int = 1, device=None) -> Mesh:
    """Every rank of the job, everything left after seq x tensor on the
    leading "data" axis: the multi-host frame-DP layout. Ranks are
    host-major under torchrun, so neighbouring data coordinates share a
    host and the seq/tensor groups stay inside one."""
    n = dist.get_world_size()
    if n % (seq * tensor):
        raise ValueError(f"{n} ranks not divisible by seq*tensor={seq * tensor}")
    return make_mesh(n // (seq * tensor), seq, tensor, device=device)


def local_data_coords(mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi) of the "data" coordinates this process feeds: its own one,
    rank // (seq * tensor)."""
    d = mesh.coord(AXIS_DATA)
    return d, d + 1
