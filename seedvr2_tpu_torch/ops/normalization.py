"""RMS and group normalisation with fp32 statistics (counterpart of
seedvr2_tpu/ops/normalization.py). Results are cast back to the input dtype."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    out = xf * (1.0 / torch.sqrt((xf * xf).mean(-1, keepdim=True) + eps))
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def group_norm(
    x: torch.Tensor,
    num_groups: int,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm over channels-last [N, ..., C]: statistics per leading index
    over every other axis and the channels of each group."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    out = ((xf - mean) * (1.0 / torch.sqrt(var + eps))).reshape(x.shape)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
