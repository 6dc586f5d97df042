"""RMS and group normalisation with fp32 statistics (counterpart of
seedvr2_tpu/ops/normalization.py). Results are cast back to the input dtype.

The VAE's per-frame GroupNorm (+ SiLU) on [B, T, H, W, C] is
``group_norm_frames``: on a CUDA tensor K8's tables
(ops/conv3d_kernel.py:gn_silu_tables), then K9, ``gn_apply``, a
hand-written pass that reads x once and writes y once
(csrc/gn_apply.cuh; not a TPU kernel: the JAX package leaves the pass to
XLA's fused elementwise ops). On a CPU tensor it runs the plain version,
``group_norm`` (+ SiLU). There is no other route: a CUDA tensor the
kernels do not take raises. K9's launch counter: ``gn_apply.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .conv3d_kernel import gn_silu_tables


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


def group_norm_frames_plain(x: torch.Tensor, gw: torch.Tensor, gb: torch.Tensor, groups: int, silu: bool,
                            eps: float = 1e-6) -> torch.Tensor:
    """Per-frame GroupNorm (statistics per (b, t)) of x [B, T, H, W, C],
    rounded to x's dtype; with ``silu``, then SiLU in fp32, rounded again:
    the JAX package's op order (models/vae/causal_conv.py, model.py)."""
    B, T, H, W, C = x.shape
    y = group_norm(x.reshape(B * T, H, W, C), groups, gw, gb, eps=eps).reshape(x.shape)
    return F.silu(y.float()).to(x.dtype) if silu else y


def group_norm_frames(x: torch.Tensor, gw: torch.Tensor, gb: torch.Tensor, groups: int, silu: bool,
                      eps: float = 1e-6) -> torch.Tensor:
    """Every GroupNorm the VAE runs outside K4. On a CUDA tensor: K8's tables
    of x, then K9 (gn_apply's contract; K8 also takes (C / groups) % 4 ==
    0); on a CPU tensor: group_norm_frames_plain."""
    if x.device.type == "cpu":
        return group_norm_frames_plain(x, gw, gb, groups, silu, eps)
    x = x.contiguous()
    scale, shift = gn_silu_tables(x, gw, gb, groups, eps)
    return gn_apply(x, scale, shift, silu)


def gn_apply_geometry(C: int) -> Tuple[int, int]:
    """(pixels a block step, steps a thread) of K9 at C channels: C / 8
    threads a pixel (16 bytes each), blocks of about 256 threads, 16 pixels
    a thread (a chunk of 64 KB of x at C = 128, 256 and 512)."""
    return max(1, 256 // (C // 8)), 16


def gn_apply_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, silu: bool) -> torch.Tensor:
    """K9's function: x * scale + shift in fp32 per frame (tables [B, T, C]),
    rounded to x's dtype; with ``silu``, then SiLU in fp32, rounded again."""
    y = (x.float() * scale[:, :, None, None, :] + shift[:, :, None, None, :]).to(x.dtype)
    return F.silu(y.float()).to(x.dtype) if silu else y


def gn_apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, silu: bool) -> torch.Tensor:
    """K9: x [B, T, H, W, C] with per-frame tables scale, shift [B, T, C]
    fp32 -> y of x's shape and dtype (gn_apply_plain's function). On a CUDA
    tensor the kernel runs; its contract: x bf16, contiguous (a view at a
    16-byte aligned storage offset is taken as it is), C % 8 == 0 (a pixel
    is whole 16-byte words), C <= 8192, B * T <= 65535; the tables fp32,
    contiguous, on x's device. Anything else raises. On a CPU tensor:
    gn_apply_plain."""
    if x.device.type == "cpu":
        return gn_apply_plain(x, scale, shift, silu)
    cuda_lib.require(x.dim() == 5, f"gn_apply: x of shape {tuple(x.shape)}")
    B, T, H, W, C = x.shape
    cuda_lib.require_cuda_tensor(x, "x", torch.bfloat16)
    cuda_lib.require(C % 8 == 0 and 8 <= C <= 8192, f"gn_apply: C={C}")
    cuda_lib.require(1 <= B * T <= 65535 and 1 <= H * W < 2**31, f"gn_apply: x {tuple(x.shape)}")
    for t, n in ((scale, "scale"), (shift, "shift")):
        cuda_lib.require_cuda_tensor(t, n, torch.float32, (B, T, C), device=x.device)
    ppb, steps = gn_apply_geometry(C)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = cuda_lib.library().seedvr2_gn_apply(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(), B * T, H * W, C, ppb, steps, int(silu),
            cuda_lib.stream_ptr(x),
        )
    cuda_lib.check(code, "gn_apply")
    gn_apply.launches += 1
    return y


gn_apply.launches = 0
