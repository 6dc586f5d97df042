"""Every collective of the port: a sum over a group and an all-gather along
one dimension.

On an NCCL group the tensors stay on the card. On a gloo group a CUDA tensor
goes through host memory explicitly: gloo's all-gather takes no CUDA
tensors, so both helpers copy to the host, run the collective there and
copy back; the kernels around them still run on the card, only the
transport differs. That is the route of two ranks sharing one card, where
NCCL refuses the second rank (chip_smoke.py phase 8), and of the CPU
tests. An all-gather moves bytes, so it sends each tensor as uint8, which
every backend takes (gloo refuses some dtypes, int16 for one).

A group of one rank (or None) is no collective: the tensor comes back as
it is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, taken in fp32 and
    returned in ``t``'s dtype on ``t``'s device (a new tensor; ``t`` is
    left as it is)."""
    if group_size(group) == 1:
        return t
    x = t.to(torch.float32, copy=True)
    if _via_host(t, group):
        x = x.cpu()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(device=t.device, dtype=t.dtype)


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes on every rank), concatenated along
    ``dim`` in rank order of ``group``."""
    n = group_size(group)
    if n == 1:
        return t
    host = _via_host(t, group)
    x = t.contiguous().reshape(-1).view(torch.uint8)
    if host:
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat([p.view(t.dtype).view(t.shape) for p in parts], dim=dim)
    return out.to(t.device) if host else out


def pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to ``size`` (the equal shapes an
    all-gather needs)."""
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)
