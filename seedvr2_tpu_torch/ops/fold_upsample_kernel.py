"""K2: the decoder's folded upsample conv (phases written interleaved).

Counterpart of seedvr2_tpu/ops/fold_upsample_kernel.py:fold_upsample_conv.
On a CUDA tensor it launches the hand-written kernel
(csrc/fold_upsample.cuh); on a CPU tensor it runs the plain version, the
JAX package's XLA form (_phase_conv + _interleave with the bias riding a
ones channel, models/vae/folded_upsample.py:148-189).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib


def _interleave(y: torch.Tensor, A: int, C: int) -> torch.Tensor:
    """[B, Tp, H+1, W+1, A*4*C] -> [B, Tp*A, 2H, 2W, C], picking each
    spatial phase's window offset (phase u/v = 1 is shifted one pixel)."""
    B, Tp, H1, W1, _ = y.shape
    H, W = H1 - 1, W1 - 1
    y = y.reshape(B, Tp, H1, W1, A, 2, 2, C)
    p00 = y[:, :, :H, :W, :, 0, 0]
    p01 = y[:, :, :H, 1:, :, 0, 1]
    p10 = y[:, :, 1:, :W, :, 1, 0]
    p11 = y[:, :, 1:, 1:, :, 1, 1]
    row0 = torch.stack([p00, p01], dim=5)  # [B, Tp, H, W, A, 2v, C]
    row1 = torch.stack([p10, p11], dim=5)
    grid = torch.stack([row0, row1], dim=4)  # [B, Tp, H, W, 2u, A, 2v, C]
    grid = grid.permute(0, 1, 5, 2, 4, 3, 6, 7)  # B, Tp, A, H, u, W, v, C
    return grid.reshape(B, Tp * A, 2 * H, 2 * W, C)


def fold_upsample_conv_plain(
    x_ext: torch.Tensor, K: torch.Tensor, btab: torch.Tensor, bc: torch.Tensor, A: int
) -> torch.Tensor:
    kt, C, P = K.shape[0], K.shape[3], K.shape[4]
    aug = torch.zeros((kt, 2, 2, C + 1, P), dtype=torch.float32, device=K.device)
    aug[:, :, :, :C] = K.float()
    aug[0, :, :, C] = btab.float()  # bias rides a ones channel that zero-pads with x
    xf = x_ext.float()
    xa = torch.cat([xf, torch.ones_like(xf[..., :1])], dim=-1)
    y = F.conv3d(xa.permute(0, 4, 1, 2, 3), aug.permute(4, 3, 0, 1, 2), padding=(0, 1, 1))
    out = _interleave(y.permute(0, 2, 3, 4, 1), A, C) + bc.float()
    return out.to(x_ext.dtype).contiguous()


def fold_upsample_conv(
    x_ext: torch.Tensor,  # [B, Tp+kt-1, H, W, C], extended in time
    K: torch.Tensor,  # [kt, 2, 2, C, A*4*C] folded weights
    btab: torch.Tensor,  # [2, 2, A*4*C] fp32 expansion-bias table
    bc: torch.Tensor,  # [C] fp32 conv bias
    A: int,
) -> torch.Tensor:
    """Returns [B, Tp*A, 2H, 2W, C]: the folded upsample conv with its
    phases interleaved, valid in time (Tp = x_ext.shape[1] - kt + 1)."""
    if x_ext.device.type == "cpu":
        return fold_upsample_conv_plain(x_ext, K, btab, bc, A)
    B, Text, H, W, C = x_ext.shape
    kt = K.shape[0]
    Tp = Text - kt + 1
    P = A * 4 * C
    cuda_lib.require(A in (1, 2) and kt in (1, 2, 3) and Tp >= 1, f"fold_upsample_conv: kt={kt} A={A} Tp={Tp}")
    cuda_lib.require(C % 64 == 0, f"fold_upsample_conv: C={C} not a multiple of 64")
    cuda_lib.require(B * Tp * A * 4 <= cuda_lib.MAX_GRID_YZ, f"fold_upsample_conv: {B * Tp * A * 4} output phase slices")
    cuda_lib.require_cuda_tensor(x_ext, "x_ext", torch.bfloat16)
    cuda_lib.require_cuda_tensor(K, "K", torch.bfloat16, (kt, 2, 2, C, P))
    cuda_lib.require_cuda_tensor(btab, "btab", torch.float32, (2, 2, P))
    cuda_lib.require_cuda_tensor(bc, "bc", torch.float32, (C,))
    cuda_lib.require(
        K.device == x_ext.device and btab.device == x_ext.device and bc.device == x_ext.device,
        "fold_upsample_conv: tensors on different devices",
    )
    y = torch.empty((B, Tp * A, 2 * H, 2 * W, C), dtype=torch.bfloat16, device=x_ext.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x_ext.device):
        code = lib.seedvr2_fold_upsample(
            x_ext.data_ptr(), K.data_ptr(), btab.data_ptr(), bc.data_ptr(), y.data_ptr(),
            B, Tp, kt, A, H, W, C, cuda_lib.stream_ptr(x_ext),
        )
    cuda_lib.check(code, "fold_upsample_conv")
    fold_upsample_conv.launches += 1
    return y


fold_upsample_conv.launches = 0
