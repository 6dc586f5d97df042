"""Sequence and tensor sharding of the DiT forward (counterpart of
seedvr2_tpu/parallel/sp.py).

In the JAX package the hints are GSPMD sharding constraints that XLA turns
into collectives. Here they are the process groups and coordinates that
NaDiT.forward reads (models/dit/nadit.py), which runs the collectives
itself (parallel/comm.py):

- seq: each rank holds a contiguous slice of the tokens (ceil(L / seq) of
  them, the last slice shorter); per layer the qkv is all-gathered, the
  rank's windows (ops/fused_window_attention.py:window_range) are
  attended, the window outputs all-gathered and the rank's tokens taken
  back; text tokens stay replicated and their outputs are summed over the
  real windows and all-reduced;
- tensor: each rank holds heads / tensor heads and the matching MLP
  columns (parallel/sharding.py); every row-parallel projection is followed
  by a sum over the tensor group, then its bias.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

from .comm import group_size
from .mesh import AXIS_SEQ, AXIS_TENSOR, Mesh

_STATE = threading.local()


class ShardingHints:
    """The groups one sharded DiT forward uses, and its seq coordinate (the
    tensor coordinate is in the weights it holds). An axis of size 1 is a
    group of one rank: no collective runs over it."""

    def __init__(self, mesh: Mesh):
        self.seq_group = mesh.group(AXIS_SEQ)
        self.tensor_group = mesh.group(AXIS_TENSOR)
        self.seq_size = group_size(self.seq_group)
        self.tensor_size = group_size(self.tensor_group)
        self.seq_rank = mesh.coord(AXIS_SEQ)

    def token_range(self, n_tokens: int) -> Tuple[int, int, int]:
        """(start, end, chunk) of this rank's tokens: chunk = ceil(L / seq)."""
        chunk = -(-n_tokens // self.seq_size)
        start = min(self.seq_rank * chunk, n_tokens)
        return start, min(start + chunk, n_tokens), chunk


def current_hints() -> Optional[ShardingHints]:
    return getattr(_STATE, "hints", None)


@contextlib.contextmanager
def sharded_dit(mesh: Mesh):
    """Shard the DiT forwards inside the block over the mesh's seq and
    tensor axes (a forward on a mesh whose both are 1 runs unsharded). The
    DiT's weights must be split over the same tensor axis
    (parallel/sharding.py:shard_dit, or load_runner with the mesh)."""
    prev = current_hints()
    _STATE.hints = ShardingHints(mesh)
    try:
        yield _STATE.hints
    finally:
        _STATE.hints = prev
