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
from seedvr2_tpu_torch.ops import flash_attention as k5
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
    _check_window_attention(cuda, rope_txt, quant_qk=False)


@pytest.mark.parametrize("rope_txt", [True, False])
def test_window_attention_int8_kernel_matches_plain(cuda, rope_txt):
    """K3q: both sides quantise the same bf16 q/k rows. The int8 step moves
    the output by about as much as the bf16 rounding, so the rel L2 bound
    alone would pass K3 here too; the kernel must also reproduce the step
    from unquantised attention to the quantised plain version: the share
    <k - u, p - u> / <p - u, p - u> is ~0.95 when q and k are quantised,
    ~0.5 when one is, ~0.05 when neither is. The kernel's rounding noise
    averages out; the plain outputs' bf16 rounding (~2e-3 of a ~1e-2 step)
    stays in the denominator and moves the ends 0.05 inwards."""
    _check_window_attention(cuda, rope_txt, quant_qk=True)


def _check_window_attention(cuda, rope_txt, quant_qk):
    g = torch.Generator(device=cuda).manual_seed(2)
    B, H, nW, S, Lt, D = 1, 2, 3, 100, 7, 128
    vqkv = torch.randn(B, 3, H, nW, S, D, device=cuda, generator=g).bfloat16()
    tqkv = torch.randn(B, 3, H, Lt, D, device=cuda, generator=g).bfloat16()
    ang = torch.rand(nW, S, D, device=cuda, generator=g) * 6
    tang = torch.rand(Lt, D, device=cuda, generator=g) * 6
    valid = torch.ones(nW, S, dtype=torch.bool, device=cuda)
    valid[1, 60:] = False  # ragged window
    norms = 1 + 0.1 * torch.randn(4, D, device=cuda, generator=g)
    args = (vqkv, tqkv, ang.cos(), ang.sin(), tang.cos(), tang.sin(), valid, rope_txt, norms, True, 1e-5, quant_qk)
    n0 = (k3.fused_window_attention.launches, k3.fused_window_attention.launches_int8)
    ov, ot = k3.fused_window_attention(*args)
    torch.cuda.synchronize()
    n1 = (k3.fused_window_attention.launches, k3.fused_window_attention.launches_int8)
    assert n1 == ((n0[0], n0[1] + 1) if quant_qk else (n0[0] + 1, n0[1]))
    pv, pt = k3.fused_window_attention_plain(*args)
    assert _rel(ov[:, :, valid.all(1)], pv[:, :, valid.all(1)]) <= REL_BOUND
    assert _rel(ov[:, :, 1, :, :60], pv[:, :, 1, :, :60]) <= REL_BOUND
    assert _rel(ot, pt) <= REL_BOUND
    if quant_qk:
        uv, ut = k3.fused_window_attention_plain(*args[:-1], False)
        rows = valid[None, None, :, :, None]  # the padded query slots of window 1 are dropped downstream
        got, ref, unq = (torch.cat([(v * rows).flatten(), t.flatten()]).float() for v, t in ((ov, ot), (pv, pt), (uv, ut)))
        share = float(((got - unq) * (ref - unq)).sum() / ((ref - unq) * (ref - unq)).sum())
        assert abs(share - 1.0) <= 0.1, share
        assert _rel(got, ref) < _rel(got, unq)


@pytest.mark.parametrize("S", [463, 64, 37])
def test_flash_attention_kernel_matches_plain(cuda, S):
    """A masked key tail, one batch row with no valid key, q_valid."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, H, D = 3, 4, 128
    q, k, v = (torch.randn(B, S, H, D, device=cuda, generator=g).bfloat16() for _ in range(3))
    kv_valid = torch.ones(B, S, dtype=torch.bool, device=cuda)
    kv_valid[0, S * 4 // 5 :] = False
    kv_valid[2] = False
    q_valid = torch.ones(B, S, dtype=torch.bool, device=cuda)
    q_valid[1, S // 2 :] = False
    n0 = k5.flash_attention.launches
    for qv in (None, q_valid):
        o = k5.flash_attention(q, k, v, kv_valid, qv)
        torch.cuda.synchronize()
        p = k5.flash_attention_plain(q, k, v, kv_valid, qv)
        assert bool(torch.isfinite(o).all())
        assert _rel(o, p) <= REL_BOUND
    assert k5.flash_attention.launches == n0 + 2
    assert not bool(o[1, S // 2 :].any())


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 3, 4, 4, 128, device=cuda)  # fp32: the kernel takes bf16
    w = torch.zeros(3, 3, 3, 128, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k1.conv3d_3x3x3(x, w, torch.zeros(128, device=cuda))
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)  # head dim 64: the kernel takes 128
    with pytest.raises(ValueError):
        k5.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k5.flash_attention(q, q, q.float())
