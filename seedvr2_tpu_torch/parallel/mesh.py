"""The rank mesh (counterpart of seedvr2_tpu/parallel/mesh.py).

A ``Mesh`` lays the ranks of the initialised ``torch.distributed`` job out
as data x seq x tensor, row-major (rank = (d * seq + s) * tensor + t, the
order of the JAX package's ``np.array(devices).reshape(data, seq, tensor)``),
and holds this rank's process group along each axis:

- "data":   frame-segment data parallelism (pipeline/multichip.py), the
            reference's one-process-per-GPU fan-out;
- "seq":    window sharding of the DiT's attention (parallel/sp.py);
- "tensor": the Megatron split of the DiT's heads and MLP
            (parallel/sharding.py).

``auto_mesh_shape`` is the JAX package's policy, copied as it is
(tests/test_torch_parallel.py holds the two equal); re-deciding it waits for
a measurement on more than one card.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_TENSOR = "tensor"
AXES = (AXIS_DATA, AXIS_SEQ, AXIS_TENSOR)


class Mesh:
    """This rank's view of a data x seq x tensor layout of the job's ranks.

    ``shape`` maps each axis to its size and ``coords`` to this rank's
    coordinate; ``group(axis)`` is the process group of the ranks that
    differ from this one only along ``axis``; ``world`` is the group of
    every rank (the tile-parallel VAE reduces over it). ``device`` is where
    this rank's tensors live."""

    def __init__(self, shape: Dict[str, int], rank: int, groups: Dict[str, object], world, device: torch.device):
        self.shape = dict(shape)
        self.rank = rank
        d, s, t = (self.shape[a] for a in AXES)
        self.coords = {AXIS_DATA: rank // (s * t), AXIS_SEQ: rank // t % s, AXIS_TENSOR: rank % t}
        self._groups = groups
        self.world = world
        self.device = device

    @property
    def size(self) -> int:
        return self.shape[AXIS_DATA] * self.shape[AXIS_SEQ] * self.shape[AXIS_TENSOR]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis]


def _default_device(rank: int) -> torch.device:
    """The card of this rank: LOCAL_RANK (torchrun sets it) or the rank,
    modulo the cards this process sees."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run the mesh on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(data: int = 1, seq: int = 1, tensor: int = 1, device=None) -> Mesh:
    """A data x seq x tensor mesh over every rank of the initialised job
    (``torch.distributed.init_process_group``, or parallel/multihost.py,
    or parallel/launch.py). The sizes must multiply to the world size.
    Every rank must call this, with the same sizes, in the same order
    (``new_group`` is collective). ``device`` defaults to this rank's card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    world_size, rank = dist.get_world_size(), dist.get_rank()
    n = data * seq * tensor
    if min(data, seq, tensor) < 1 or n != world_size:
        raise ValueError(f"mesh {data}x{seq}x{tensor} needs {n} ranks, the job has {world_size}")
    shape = {AXIS_DATA: data, AXIS_SEQ: seq, AXIS_TENSOR: tensor}
    groups = {}
    strides = {AXIS_DATA: seq * tensor, AXIS_SEQ: tensor, AXIS_TENSOR: 1}
    for axis in AXES:
        size, stride = shape[axis], strides[axis]
        # every line of ranks along ``axis``: the ranks whose other coordinates agree
        starts = [r for r in range(n) if (r // stride) % size == 0]
        for start in starts:
            ranks = [start + i * stride for i in range(size)]
            g = dist.new_group(ranks)  # collective: every rank creates every group
            if rank in ranks:
                groups[axis] = g
    device = torch.device(device) if device is not None else _default_device(rank)
    return Mesh(shape, rank, groups, dist.group.WORLD, device)


def auto_mesh_shape(
    n_devices: int,
    n_frames: Optional[int] = None,
    heads: int = 0,
    model_bytes: int = 0,
    hbm_bytes: int = 0,
) -> Tuple[int, int, int]:
    """Workload-aware (data, seq, tensor) factorization of ``n_devices``,
    the JAX package's policy unchanged:

    1. Tensor-shard the DiT only as much as required for the weights to fit
       beside activations (weights > ~50% of device memory per card).
    2. Frame data-parallelism takes everything that remains when the video
       has >= 2 frames per data shard.
    3. Images / short clips put the leftover ranks on "tensor" (bounded by
       head divisibility); VAE tiles ride the whole mesh either way
       (Runner._tile_parallel).

    Unknown workloads (n_frames=None) behave like long videos: data-first.
    """
    n = n_devices
    if n <= 1:
        return (1, 1, 1)

    def tensor_ok(c: int) -> bool:
        return n % c == 0 and (heads == 0 or heads % c == 0)

    tensor = 1
    if model_bytes and hbm_bytes:
        while tensor < n and model_bytes / tensor > 0.5 * hbm_bytes and tensor_ok(tensor * 2):
            tensor *= 2
    data = n // tensor
    if n_frames is None or n_frames >= 2 * data:
        return (data, 1, tensor)
    while tensor < n and tensor_ok(tensor * 2) and (n_frames < 2 * (n // tensor) or tensor == 1):
        tensor *= 2
    return (n // tensor, 1, tensor)


def auto_mesh(
    n_devices: Optional[int] = None,
    n_frames: Optional[int] = None,
    heads: int = 0,
    model_bytes: int = 0,
    hbm_bytes: int = 0,
    device=None,
) -> Mesh:
    """Default inference mesh for the workload (auto_mesh_shape) over the
    job's ranks; ``n_devices`` defaults to the world size."""
    n = n_devices or dist.get_world_size()
    d, s, t = auto_mesh_shape(n, n_frames, heads, model_bytes, hbm_bytes)
    return make_mesh(d, s, t, device=device)


def build_mesh(spec: str, n_frames: Optional[int], dit_cfg, device=None, quantize: Optional[str] = None,
               dit_model: str = "") -> Optional[Mesh]:
    """The mesh of one invocation, as the JAX CLI and node layer build it
    (inference_cli.py:build_mesh, interfaces.py:_build_mesh): None on one
    rank (or without an initialised job); ``"auto"`` sizes the mesh with
    auto_mesh_shape from the frame count, the DiT's heads and its resident
    weight bytes against this rank's device memory: int8 bytes where the
    loader will store int8 (``quantize``, its auto_quantize default, or a
    .gguf ``dit_model``), as inference_cli.py:_estimate_dit counts them;
    ``"d,s,t"`` is taken as given."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    if spec != "auto":
        d, s, t = (int(x) for x in spec.split(","))
        return make_mesh(d, s, t, device=device)
    from ..pipeline.loader import dit_param_bytes, resident_quantize
    from ..pipeline.phases import _hbm_bytes

    dev = torch.device(device) if device is not None else _default_device(dist.get_rank())
    hbm = _hbm_bytes(dev)
    model_bytes = dit_param_bytes(dit_cfg, resident_quantize(dit_cfg, dit_model, quantize, hbm))
    return auto_mesh(n_frames=n_frames, heads=dit_cfg.heads, model_bytes=model_bytes, hbm_bytes=hbm, device=dev)
