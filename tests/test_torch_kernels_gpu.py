"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at small shapes (a mirror of chip_smoke.py's kernel phase).

Marked ``gpu``: without a CUDA device every test skips, decided inside the
``cuda`` fixture so that all pytest-xdist workers collect the same tests.
On a machine with a card (and no jax):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Bound: ||kernel - plain||_2 / ||plain||_2 <= 1e-2. Both sides read the same
bf16 inputs and accumulate in fp32; the kernel rounds its output (and, in
K3, the softmax numerators) to bf16, which is ~4e-3 relative.
"""

import pytest
import torch

from seedvr2_tpu_torch.ops import conv3d_kernel as k1
from seedvr2_tpu_torch.ops import fold_upsample_kernel as k2
from seedvr2_tpu_torch.ops import fused_window_attention as k3

pytestmark = pytest.mark.gpu

REL_BOUND = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("cin,cout,H,W", [(128, 128, 9, 13), (256, 128, 16, 16), (128, 256, 5, 70)])
def test_conv3d_kernel_matches_plain(cuda, cin, cout, H, W):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 4, H, W, cin, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn(cout, device=cuda, generator=g)
    n0 = k1.conv3d_3x3x3.launches
    y = k1.conv3d_3x3x3(x, w, b)
    torch.cuda.synchronize()
    assert k1.conv3d_3x3x3.launches == n0 + 1
    assert _rel(y, k1.conv3d_3x3x3_plain(x, w, b)) <= REL_BOUND


@pytest.mark.parametrize("kt,A", [(1, 1), (2, 2), (3, 1)])
def test_fold_upsample_kernel_matches_plain(cuda, kt, A):
    g = torch.Generator(device=cuda).manual_seed(1)
    C, H, W = 128, 9, 11
    x = torch.randn(1, kt + 1, H, W, C, device=cuda, generator=g).bfloat16()
    K = (torch.randn(kt, 2, 2, C, A * 4 * C, device=cuda, generator=g) / (kt * 4 * C) ** 0.5).bfloat16()
    btab = torch.randn(2, 2, A * 4 * C, device=cuda, generator=g)
    bc = torch.randn(C, device=cuda, generator=g)
    y = k2.fold_upsample_conv(x, K, btab, bc, A)
    torch.cuda.synchronize()
    assert y.shape == (1, 2 * A, 2 * H, 2 * W, C)
    assert _rel(y, k2.fold_upsample_conv_plain(x, K, btab, bc, A)) <= REL_BOUND


@pytest.mark.parametrize("rope_txt", [True, False])
def test_window_attention_kernel_matches_plain(cuda, rope_txt):
    g = torch.Generator(device=cuda).manual_seed(2)
    B, H, nW, S, Lt, D = 1, 2, 3, 100, 7, 128
    vqkv = torch.randn(B, 3, H, nW, S, D, device=cuda, generator=g).bfloat16()
    tqkv = torch.randn(B, 3, H, Lt, D, device=cuda, generator=g).bfloat16()
    ang = torch.rand(nW, S, D, device=cuda, generator=g) * 6
    tang = torch.rand(Lt, D, device=cuda, generator=g) * 6
    valid = torch.ones(nW, S, dtype=torch.bool, device=cuda)
    valid[1, 60:] = False  # ragged window
    norms = 1 + 0.1 * torch.randn(4, D, device=cuda, generator=g)
    args = (vqkv, tqkv, ang.cos(), ang.sin(), tang.cos(), tang.sin(), valid, rope_txt, norms, True, 1e-5)
    ov, ot = k3.fused_window_attention(*args)
    torch.cuda.synchronize()
    pv, pt = k3.fused_window_attention_plain(*args)
    assert _rel(ov[:, :, valid.all(1)], pv[:, :, valid.all(1)]) <= REL_BOUND
    assert _rel(ov[:, :, 1, :, :60], pv[:, :, 1, :, :60]) <= REL_BOUND
    assert _rel(ot, pt) <= REL_BOUND


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 3, 4, 4, 128, device=cuda)  # fp32: the kernel takes bf16
    w = torch.zeros(3, 3, 3, 128, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k1.conv3d_3x3x3(x, w, torch.zeros(128, device=cuda))
