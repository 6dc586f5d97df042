"""K1: stride-1 3x3x3 convolution of the VAE (channels-last).

Counterpart of seedvr2_tpu/ops/conv3d_kernel.py:conv3d_3x3x3. On a CUDA
tensor it launches the hand-written implicit-GEMM kernel
(csrc/conv3d.cuh); on a CPU tensor it runs the plain version below. There is
no other route: a CUDA tensor the kernel does not take raises.
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


def conv3d_3x3x3_plain(x_ext: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """F.conv3d in fp32 on permuted views; bias added in fp32, one rounding
    to the input dtype at the end (the kernel's numerics)."""
    xf = x_ext.float().permute(0, 4, 1, 2, 3)
    wf = w.float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf, None if b is None else b.float(), padding=(0, 1, 1))
    return y.permute(0, 2, 3, 4, 1).to(x_ext.dtype).contiguous()


def conv3d_3x3x3(x_ext: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x_ext [B, T+2, H, W, Cin] (already extended in time), w [3, 3, 3,
    Cin, Cout] (DHWIO, i.e. [27, Cin, Cout] row-major), b [Cout] fp32.
    Returns [B, T, H, W, Cout]: SAME spatial padding, valid in time."""
    if x_ext.device.type == "cpu":
        return conv3d_3x3x3_plain(x_ext, w, b)
    B, Text, H, W, cin = x_ext.shape
    cout = w.shape[-1]
    T = Text - 2
    cuda_lib.require(T >= 1, f"conv3d_3x3x3: need T+2 >= 3 frames, got {Text}")
    cuda_lib.require(cin % 32 == 0 and cout % 64 == 0, f"conv3d_3x3x3: channels {cin}->{cout} not supported")
    cuda_lib.require(B * T <= cuda_lib.MAX_GRID_YZ, f"conv3d_3x3x3: B*T={B * T} frames per launch")
    cuda_lib.require_cuda_tensor(x_ext, "x_ext", torch.bfloat16)
    cuda_lib.require_cuda_tensor(w, "w", torch.bfloat16, (3, 3, 3, cin, cout))
    cuda_lib.require_cuda_tensor(b, "b", torch.float32, (cout,))
    cuda_lib.require(w.device == x_ext.device and b.device == x_ext.device, "conv3d_3x3x3: tensors on different devices")
    y = torch.empty((B, T, H, W, cout), dtype=torch.bfloat16, device=x_ext.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x_ext.device):
        code = lib.seedvr2_conv3d_3x3x3(
            x_ext.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            B, T, H, W, cin, cout, cuda_lib.stream_ptr(x_ext),
        )
    cuda_lib.check(code, "conv3d_3x3x3")
    conv3d_3x3x3.launches += 1
    return y


conv3d_3x3x3.launches = 0
