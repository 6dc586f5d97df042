"""K1, K4 and K6: the stride-1 3x3x3 convolution of the VAE (channels-last).

Counterpart of seedvr2_tpu/ops/conv3d_kernel.py:
- ``conv3d_3x3x3(x_ext, w, b)`` is K1;
- ``conv3d_3x3x3(x_ext, w, b, scale, shift)`` is K4, the same conv with
  silu(x * scale + shift) applied to its input as it is loaded (the
  resnet's per-frame GroupNorm + SiLU, folded into tables by
  ``gn_silu_tables``; template flag of the same kernel);
- ``gn_silu_tables(x_ext, gw, gb, groups)`` is K8, those tables: not a TPU
  kernel (the JAX package leaves them to XLA's reductions), a hand-written
  one because their plain version cost more than K4 (csrc/gn_stats.cuh);
- ``conv3d_3x3x3_im2col(x_ext, w, b)`` is K6, the conv as one product over
  the folded [M, 27*Cin] axis: the kernel K1 runs too.
All three are csrc/conv3d.cuh's policy on the TMA + wgmma pipeline of
csrc/conv_pipeline.cuh (K2, ops/fold_upsample_kernel.py, is the same
kernel with another policy). On a CUDA tensor each launches its
hand-written kernel; on a CPU tensor it runs the plain version below.
There is no other route: a CUDA tensor the kernel does not take raises.
Each has its own C entry and launch counter: ``conv3d_3x3x3.launches``
(K1), ``conv3d_3x3x3.launches_gn`` (K4), ``conv3d_3x3x3_im2col.launches``
(K6), ``gn_silu_tables.launches`` (K8).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib


def enabled_for(w_shape: Tuple[int, ...], stride: Tuple[int, int, int]) -> bool:
    """The routing rule of the JAX package (conv3d_kernel.enabled_for):
    stride-1 3x3x3 convs whose Cin and Cout are multiples of 128."""
    kt, kh, kw, cin, cout = w_shape
    return (kt, kh, kw) == (3, 3, 3) and tuple(stride) == (1, 1, 1) and cin % 128 == 0 and cout % 128 == 0


def gn_stats_geometry(C: int) -> Tuple[int, int]:
    """(pixels a block step, steps a thread) of K8's partials kernel at C
    channels: C / 8 threads a pixel (16 bytes each), blocks of about 256
    threads, 64 steps, so a chunk of the frame is ppb * 64 pixels (256 KB of
    x at C = 128, 256 and 512). The kernel takes both from here, and so does
    the CPU emulation of its merge order (tests/test_torch_gn_stats.py)."""
    return max(1, 256 // (C // 8)), 64


def gn_stats_launch(lib, x_ext: torch.Tensor, gw: torch.Tensor, gb: torch.Tensor, groups: int, eps: float = 1e-6):
    """K8's launches from ``lib`` (None: this tree's library, loaded once the
    arguments pass; or another tree's in conv_ab): the tables (scale,
    shift) [B, T, C] fp32 of a CUDA x_ext. The contract: x_ext bf16 [B, T,
    H, W, C], contiguous (a view at a 16-byte aligned storage offset is
    taken as it is), C % 8 == 0 (a pixel is whole 16-byte words), C %
    groups == 0 and (C / groups) % 4 == 0, C <= 8192,
    B * T <= 65535; gw and gb [C], both fp32 or both bf16 (the VAE's norm
    weights). Anything else raises. Not counted: the caller counts."""
    cuda_lib.require(x_ext.dim() == 5, f"gn_silu_tables: x_ext of shape {tuple(x_ext.shape)}")
    B, T, H, W, C = x_ext.shape
    cuda_lib.require_cuda_tensor(x_ext, "x_ext", torch.bfloat16)
    cuda_lib.require(C % 8 == 0 and C <= 8192 and groups >= 1 and C % groups == 0 and (C // groups) % 4 == 0,
                     f"gn_silu_tables: C={C}, groups={groups}")
    cuda_lib.require(1 <= B * T <= 65535 and H * W >= 1 and H * W < 2**31, f"gn_silu_tables: x_ext {tuple(x_ext.shape)}")
    cuda_lib.require(gw.dtype in (torch.float32, torch.bfloat16) and gb.dtype == gw.dtype,
                     f"gn_silu_tables: gw {gw.dtype}, gb {gb.dtype}")
    for t, n in ((gw, "gw"), (gb, "gb")):
        cuda_lib.require_cuda_tensor(t, n, gw.dtype, (C,), device=x_ext.device)
    ppb, steps = gn_stats_geometry(C)
    chunks = -(-(H * W) // (ppb * steps))
    part = torch.empty((B * T, chunks, groups, 2), dtype=torch.float32, device=x_ext.device)
    scale = torch.empty((B, T, C), dtype=torch.float32, device=x_ext.device)
    shift = torch.empty_like(scale)
    with torch.cuda.device(x_ext.device):
        code = (cuda_lib.library() if lib is None else lib).seedvr2_gn_stats(
            x_ext.data_ptr(), gw.data_ptr(), gb.data_ptr(), part.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            B * T, H * W, C, groups, ppb, steps, int(gw.dtype == torch.bfloat16), eps, cuda_lib.stream_ptr(x_ext),
        )
    cuda_lib.check(code, "gn_silu_tables")
    return scale, shift


def gn_silu_tables(x_ext: torch.Tensor, gw: torch.Tensor, gb: torch.Tensor, groups: int, eps: float = 1e-6):
    """K4's tables (scale, shift) [B, T, C] fp32 of a RAW x_ext [B, T, H, W,
    C]: x * scale + shift == GroupNorm(x) * gw + gb per frame (b, t). On a
    CUDA tensor K8 computes them (gn_stats_launch's contract); on a CPU
    tensor the plain version does."""
    if x_ext.device.type == "cpu":
        return gn_silu_tables_plain(x_ext, gw, gb, groups, eps)
    out = gn_stats_launch(None, x_ext, gw, gb, groups, eps)
    gn_silu_tables.launches += 1
    return out


gn_silu_tables.launches = 0


def gn_silu_tables_plain(x_ext: torch.Tensor, gw: torch.Tensor, gb: torch.Tensor, groups: int, eps: float = 1e-6):
    """Per-frame GroupNorm folded into fp32 tables (scale, shift) [B, T, C]
    with x * scale + shift == GroupNorm(x) * gw + gb per (b, t), for a RAW
    x_ext [B, T, H, W, C]. Two-pass fp32 variance, as the JAX package
    (and ops/normalization.group_norm) computes it. Each sum runs over a
    group's channels first, then over the pixels: one reduction over the
    two strided axes at once loses ~10x more to fp32 rounding (2.5e-6 vs
    2.4e-7 from the JAX tables at the JAX package's test shapes)."""
    B, T, H, W, C = x_ext.shape
    n = H * W * (C // groups)
    xf = x_ext.float().reshape(B, T, H * W, groups, C // groups)
    mean = xf.sum(4, keepdim=True).sum(2, keepdim=True) / n
    var = (xf - mean).square().sum(4, keepdim=True).sum(2, keepdim=True) / n
    rstd = 1.0 / torch.sqrt(var + eps)
    mean_c = mean[:, :, 0].expand(B, T, groups, C // groups).reshape(B, T, C)
    rstd_c = rstd[:, :, 0].expand(B, T, groups, C // groups).reshape(B, T, C)
    scale = rstd_c * gw.float()
    shift = gb.float() - mean_c * scale
    return scale.contiguous(), shift.contiguous()


def gn_silu_apply(x_ext: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """K4's prologue as a tensor op: silu(x * scale + shift) in fp32, rounded
    once to x's dtype."""
    xf = x_ext.float() * scale[:, :, None, None, :] + shift[:, :, None, None, :]
    return F.silu(xf).to(x_ext.dtype)


def conv3d_3x3x3_plain(
    x_ext: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """F.conv3d in fp32 on permuted views; bias added in fp32, one rounding
    to the input dtype at the end (the kernels' numerics). With tables (K4)
    the input is first normalised as the kernel loads it (gn_silu_apply);
    F.conv3d's zero padding then lies outside the image, after the
    normalisation, as the kernel's predicated loads do."""
    if scale is not None:
        x_ext = gn_silu_apply(x_ext, scale, shift)
    xf = x_ext.float().permute(0, 4, 1, 2, 3)
    wf = w.float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf, None if b is None else b.float(), padding=(0, 1, 1))
    return y.permute(0, 2, 3, 4, 1).to(x_ext.dtype).contiguous()


def _check_conv_args(name, x_ext, w, b):
    """The kernel's contract: bf16 x_ext and w, fp32 b, on one device;
    Cin % 64 == 0 (its stage depth) and Cout % 128 == 0 (its tile width;
    every conv the routing rule sends here is 128-512 wide). x_ext and w
    are read through TMA tensor maps encoded from their data pointers, so a
    contiguous view at a storage offset is taken as it is when that pointer
    is 16-byte aligned, and refused when it is not (never copied)."""
    B, Text, H, W, cin = x_ext.shape
    cout = w.shape[-1]
    T = Text - 2
    cuda_lib.require(T >= 1, f"{name}: need T+2 >= 3 frames, got {Text}")
    cuda_lib.require(cin % 64 == 0 and cout % 128 == 0, f"{name}: channels {cin}->{cout} not supported")
    cuda_lib.require_cuda_tensor(x_ext, "x_ext", torch.bfloat16)
    cuda_lib.require_cuda_tensor(w, "w", torch.bfloat16, (3, 3, 3, cin, cout))
    cuda_lib.require_cuda_tensor(b, "b", torch.float32, (cout,))
    cuda_lib.require(w.device == x_ext.device and b.device == x_ext.device, f"{name}: tensors on different devices")
    return B, T, H, W, cin, cout


def conv3d_3x3x3(
    x_ext: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x_ext [B, T+2, H, W, Cin] (already extended in time), w [3, 3, 3,
    Cin, Cout] (DHWIO, i.e. [27, Cin, Cout] row-major), b [Cout] fp32.
    Returns [B, T, H, W, Cout]: SAME spatial padding, valid in time. With
    ``scale``/``shift`` [B, T+2, Cin] fp32 (gn_silu_tables of x_ext) the
    conv reads silu(x * scale + shift) instead of x (K4). The kernel takes
    Cin % 64 == 0 and Cout % 128 == 0 (every conv the routing rule sends
    here), and views at a 16-byte aligned storage offset
    (_check_conv_args)."""
    if (scale is None) != (shift is None):
        raise ValueError("conv3d_3x3x3: give both scale and shift, or neither")
    if x_ext.device.type == "cpu":
        return conv3d_3x3x3_plain(x_ext, w, b, scale, shift)
    B, T, H, W, cin, cout = _check_conv_args("conv3d_3x3x3", x_ext, w, b)
    gn = scale is not None
    if gn:
        for t, n in ((scale, "scale"), (shift, "shift")):
            cuda_lib.require_cuda_tensor(t, n, torch.float32, (B, T + 2, cin))
            cuda_lib.require(t.device == x_ext.device, f"conv3d_3x3x3: {n} on another device")
    y = torch.empty((B, T, H, W, cout), dtype=torch.bfloat16, device=x_ext.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x_ext.device):
        code = lib.seedvr2_conv3d_3x3x3(
            x_ext.data_ptr(), w.data_ptr(), b.data_ptr(),
            scale.data_ptr() if gn else None, shift.data_ptr() if gn else None, y.data_ptr(),
            B, T, H, W, cin, cout, cuda_lib.stream_ptr(x_ext),
        )
    cuda_lib.check(code, "conv3d_3x3x3")
    if gn:
        conv3d_3x3x3.launches_gn += 1
    else:
        conv3d_3x3x3.launches += 1
    return y


conv3d_3x3x3.launches = 0
conv3d_3x3x3.launches_gn = 0


def conv3d_3x3x3_im2col_plain(x_ext: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """The folded product's value: the same conv as K1's plain version (a
    materialised [M, 27*Cin] column matrix would be 27x the input)."""
    return conv3d_3x3x3_plain(x_ext, w, b)


def conv3d_3x3x3_im2col(x_ext: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6: the same contract as conv3d_3x3x3 (no tables), computed as one
    product over the folded K axis; the kernel takes ``w`` viewed flat as
    [27*Cin, Cout] (_check_conv_args). It is K1's kernel, through its own
    C entry and counter."""
    if x_ext.device.type == "cpu":
        return conv3d_3x3x3_im2col_plain(x_ext, w, b)
    B, T, H, W, cin, cout = _check_conv_args("conv3d_3x3x3_im2col", x_ext, w, b)
    wf = w.view(27 * cin, cout)
    y = torch.empty((B, T, H, W, cout), dtype=torch.bfloat16, device=x_ext.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x_ext.device):
        code = lib.seedvr2_conv3d_im2col(
            x_ext.data_ptr(), wf.data_ptr(), b.data_ptr(), y.data_ptr(), B, T, H, W, cin, cout,
            cuda_lib.stream_ptr(x_ext),
        )
    cuda_lib.check(code, "conv3d_3x3x3_im2col")
    conv3d_3x3x3_im2col.launches += 1
    return y


conv3d_3x3x3_im2col.launches = 0


def kernel_attributes(gn: bool = False) -> dict:
    """The kernel of K1 and K6 (or, with ``gn``, K4's) as the CUDA runtime
    holds it: registers a thread, local memory (spills) a thread, and the
    dynamic shared memory it launches with."""
    return cuda_lib.attributes("seedvr2_conv3d_attributes", int(gn))
