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
from seedvr2_tpu_torch.ops import quant

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


# The conv core's edges: H, W not multiples of the 16 x 16 output patch
# (9 x 17; W < 16), Cin != Cout (512 -> 256, 256 -> 128, 128 -> 256), B = 2
# at T = 1, several patches and 128-column blocks (33 x 40, Cout 256).
CONV_CASES = [(2, 2, 128, 128, 9, 13), (2, 2, 256, 128, 16, 16), (2, 2, 128, 256, 5, 70), (1, 2, 128, 128, 9, 17),
              (1, 1, 128, 128, 5, 7), (2, 1, 512, 256, 9, 17), (2, 1, 256, 128, 17, 12), (1, 2, 128, 256, 33, 40)]


@pytest.mark.parametrize("B,T,cin,cout,H,W", CONV_CASES)
def test_conv3d_kernel_matches_plain(cuda, B, T, cin, cout, H, W):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, T + 2, H, W, cin, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn(cout, device=cuda, generator=g)
    n0 = k1.conv3d_3x3x3.launches
    y = k1.conv3d_3x3x3(x, w, b)
    torch.cuda.synchronize()
    assert k1.conv3d_3x3x3.launches == n0 + 1
    assert _rel(y, k1.conv3d_3x3x3_plain(x, w, b)) <= REL_BOUND


def _gn_case(cuda, cin, cout, H, W, T=3, B=2):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(B, T + 2, H, W, cin, device=cuda, generator=g) * 0.7 + 0.3).bfloat16()
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn(cout, device=cuda, generator=g)
    gw = 1 + 0.2 * torch.randn(cin, device=cuda, generator=g)
    gb = 0.3 * torch.randn(cin, device=cuda, generator=g)
    scale, shift = k1.gn_silu_tables(x, gw, gb, 32)
    return x, w, b, scale, shift


@pytest.mark.parametrize("B,T,cin,cout,H,W", CONV_CASES + [(2, 3, 128, 128, 3, 100), (1, 1, 256, 256, 16, 16)])
def test_conv3d_gn_kernel_matches_plain(cuda, B, T, cin, cout, H, W):
    """K4. Most cases leave a ragged patch; 5 x 7 and 16 x 16 are one
    patch whose halo crosses the image edge on all four sides, 3 x 100 is
    all halo rows: there the kernel must load zeros, not silu(shift) (which
    the tables make far from 0)."""
    x, w, b, scale, shift = _gn_case(cuda, cin, cout, H, W, T, B)
    assert float(torch.nn.functional.silu(shift).abs().mean()) > 0.05
    n0 = (k1.conv3d_3x3x3.launches, k1.conv3d_3x3x3.launches_gn)
    y = k1.conv3d_3x3x3(x, w, b, scale, shift)
    torch.cuda.synchronize()
    assert (k1.conv3d_3x3x3.launches, k1.conv3d_3x3x3.launches_gn) == (n0[0], n0[1] + 1)
    ref = k1.conv3d_3x3x3_plain(x, w, b, scale, shift)
    assert _rel(y, ref) <= REL_BOUND
    border = torch.zeros(H, W, dtype=torch.bool, device=cuda)
    border[0], border[-1], border[:, 0], border[:, -1] = True, True, True, True
    assert _rel(y[:, :, border], ref[:, :, border]) <= REL_BOUND
    # the unfused route (normalise, then K1) computes the same function
    unfused = k1.conv3d_3x3x3(k1.gn_silu_apply(x, scale, shift).contiguous(), w, b)
    assert _rel(unfused, ref) <= REL_BOUND


def _check_im2col(cuda, B, T, cin, cout, H, W):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(B, T + 2, H, W, cin, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn(cout, device=cuda, generator=g)
    n0 = (k1.conv3d_3x3x3_im2col.launches, k1.conv3d_3x3x3.launches)
    y = k1.conv3d_3x3x3_im2col(x, w, b)
    torch.cuda.synchronize()
    assert (k1.conv3d_3x3x3_im2col.launches, k1.conv3d_3x3x3.launches) == (n0[0] + 1, n0[1])
    ref = k1.conv3d_3x3x3_im2col_plain(x, w, b)
    assert bool(torch.isfinite(y).all())
    assert _rel(y, ref) <= REL_BOUND
    # the image border (TMA's zero fill is the SAME padding) and the last frame
    border = torch.zeros(H, W, dtype=torch.bool, device=cuda)
    border[0], border[-1], border[:, 0], border[:, -1] = True, True, True, True
    assert _rel(y[:, :, border], ref[:, :, border]) <= REL_BOUND
    assert _rel(y[:, -1], ref[:, -1]) <= REL_BOUND
    assert _rel(y, k1.conv3d_3x3x3(x, w, b)) <= REL_BOUND


@pytest.mark.parametrize("cin,cout,H,W", [(128, 128, 9, 13), (256, 128, 16, 16), (128, 256, 5, 70)])
def test_conv3d_im2col_kernel_matches_plain(cuda, cin, cout, H, W):
    """K6 against its plain version and against K1 on the same inputs."""
    _check_im2col(cuda, 2, 2, cin, cout, H, W)


# K6's tiling edges: the patch it picks (16 x 16, 8 x 32 or 4 x 64:
# the fewest tiles) against H, W that are not multiples of it, W below the
# patch width (9 x 13, 20 x 7), B = 2 at T = 1 and T = 3, Cin != Cout, Cout
# 128 / 256 / 512 (one to four column tiles), Cin 64 (one stage a tap) and
# 512, and more tiles than SMs (160 x 160 x 3 frames: 300 tiles, so blocks
# walk several tiles and the ring runs on across them).
IM2COL_CASES = [(2, 1, 64, 128, 9, 13), (2, 3, 128, 256, 20, 7), (1, 2, 512, 128, 17, 33), (1, 1, 256, 512, 10, 70),
                (2, 1, 128, 128, 8, 64), (1, 1, 128, 128, 4, 130), (1, 3, 128, 256, 160, 160),
                (2, 2, 512, 256, 36, 40), (1, 1, 64, 512, 24, 24)]


@pytest.mark.parametrize("B,T,cin,cout,H,W", IM2COL_CASES)
def test_conv3d_im2col_kernel_edges(cuda, B, T, cin, cout, H, W):
    _check_im2col(cuda, B, T, cin, cout, H, W)


def test_conv3d_im2col_kernel_resources(cuda):
    """K6 launches 384 threads with every register the launch bound allows:
    setmaxnreg then moves them from the producer warpgroup (40) to the two
    consumers (232), which waits forever if the pool is short. No spills,
    and its shared memory within the 227 KB a block may take."""
    a = k1.im2col_kernel_attributes()
    assert a["registers"] * 384 >= 40 * 128 + 232 * 256, a
    assert a["local_bytes"] == 0, a
    assert 48 * 1024 < a["smem_bytes"] <= 232448, a


@pytest.mark.parametrize("C", [128, 256, 512])
@pytest.mark.parametrize("kt,A", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2)])
def test_fold_upsample_kernel_matches_plain(cuda, kt, A, C):
    """Every (kt, A) the kernel takes at the decoder's widths; H, W odd and
    past one 16 x 16 patch, so the ragged patch and the masked bias table
    at every edge are covered."""
    g = torch.Generator(device=cuda).manual_seed(1)
    H, W = 19, 17
    x = torch.randn(1, kt + 1, H, W, C, device=cuda, generator=g).bfloat16()
    K = (torch.randn(kt, 2, 2, C, A * 4 * C, device=cuda, generator=g) / (kt * 4 * C) ** 0.5).bfloat16()
    btab = torch.randn(2, 2, A * 4 * C, device=cuda, generator=g)
    bc = torch.randn(C, device=cuda, generator=g)
    y = k2.fold_upsample_conv(x, K, btab, bc, A)
    torch.cuda.synchronize()
    assert y.shape == (1, 2 * A, 2 * H, 2 * W, C)
    assert _rel(y, k2.fold_upsample_conv_plain(x, K, btab, bc, A)) <= REL_BOUND


# Window attention corners a register-resident kernel can get wrong: the
# original 3-window case (window 1 ragged), a window whose video slots are
# all invalid (its keys are text only), B = 2, no qk norm, R = S + Lt an
# exact multiple of the 128-row query tile and one row over, and all-zero
# q/k rows (K3q's scale is then 1e-8 and every code 0).
_WINDOW_CASES = {
    "True": dict(rope_txt=True),
    "False": dict(rope_txt=False),
    "all_invalid": dict(invalid_window=2),
    "B2": dict(B=2),
    "no_qk_norm": dict(qk_norm=False),
    "R128": dict(S=120, Lt=8, nW=2),
    "R129": dict(S=121, Lt=8, nW=2),
    "zero_rows": dict(zero_rows=True),
}


@pytest.mark.parametrize("case", list(_WINDOW_CASES))
def test_window_attention_kernel_matches_plain(cuda, case):
    _check_window_attention(cuda, quant_qk=False, **_WINDOW_CASES[case])


@pytest.mark.parametrize("case", list(_WINDOW_CASES))
def test_window_attention_int8_kernel_matches_plain(cuda, case):
    """K3q: both sides quantise the same bf16 q/k rows. The int8 step moves
    the output by about as much as the bf16 rounding, so the rel L2 bound
    alone would pass K3 here too; the kernel must also reproduce the step
    from unquantised attention to the quantised plain version: the share
    <k - u, p - u> / <p - u, p - u> is ~0.95 when q and k are quantised,
    ~0.5 when one is, ~0.05 when neither is. The kernel's rounding noise
    averages out; the plain outputs' bf16 rounding (~2e-3 of a ~1e-2 step)
    stays in the denominator and moves the ends 0.05 inwards."""
    _check_window_attention(cuda, quant_qk=True, **_WINDOW_CASES[case])


def _check_window_attention(cuda, quant_qk, rope_txt=True, B=1, nW=3, S=100, Lt=7, qk_norm=True, invalid_window=None,
                            zero_rows=False):
    g = torch.Generator(device=cuda).manual_seed(2)
    H, D = 2, 128
    vqkv = torch.randn(B, 3, H, nW, S, D, device=cuda, generator=g).bfloat16()
    tqkv = torch.randn(B, 3, H, Lt, D, device=cuda, generator=g).bfloat16()
    if zero_rows:  # q and k of video slot 5 of window 0 and of text token 1
        vqkv[:, :2, :, 0, 5] = 0
        tqkv[:, :2, :, 1] = 0
    ang = torch.rand(nW, S, D, device=cuda, generator=g) * 6
    tang = torch.rand(Lt, D, device=cuda, generator=g) * 6
    valid = torch.ones(nW, S, dtype=torch.bool, device=cuda)
    valid[1, 60:] = False  # ragged window
    if invalid_window is not None:
        valid[invalid_window] = False
    norms = 1 + 0.1 * torch.randn(4, D, device=cuda, generator=g)
    args = (vqkv, tqkv, ang.cos(), ang.sin(), tang.cos(), tang.sin(), valid, rope_txt, norms, qk_norm, 1e-5, quant_qk)
    n0 = (k3.fused_window_attention.launches, k3.fused_window_attention.launches_int8)
    ov, ot = k3.fused_window_attention(*args)
    torch.cuda.synchronize()
    n1 = (k3.fused_window_attention.launches, k3.fused_window_attention.launches_int8)
    assert n1 == ((n0[0], n0[1] + 1) if quant_qk else (n0[0] + 1, n0[1]))
    pv, pt = k3.fused_window_attention_plain(*args)
    assert bool(torch.isfinite(ov).all()) and bool(torch.isfinite(ot).all())
    # every row, the padded video slots' queries included (they attend like any other)
    assert _rel(ov, pv) <= REL_BOUND
    assert _rel(ot, pt) <= REL_BOUND
    if invalid_window is not None:
        assert _rel(ov[:, :, invalid_window], pv[:, :, invalid_window]) <= REL_BOUND
    if zero_rows:
        assert _rel(ov[:, :, 0, 5], pv[:, :, 0, 5]) <= REL_BOUND
    if quant_qk:
        uv, ut = k3.fused_window_attention_plain(*args[:-1], False)
        rows = valid[None, None, :, :, None]  # the padded query slots are dropped downstream
        got, ref, unq = (torch.cat([(v * rows).flatten(), t.flatten()]).float() for v, t in ((ov, ot), (pv, pt), (uv, ut)))
        share = float(((got - unq) * (ref - unq)).sum() / ((ref - unq) * (ref - unq)).sum())
        assert abs(share - 1.0) <= 0.1, share
        assert _rel(got, ref) < _rel(got, unq)


@pytest.mark.parametrize("quant_qk", [False, True])
@pytest.mark.parametrize("nW,seq", [(5, 2), (3, 4), (4, 1)])
def test_sharded_window_attention_ranks_equal_the_unsharded_kernel(cuda, nW, seq, quant_qk):
    """K3s: every seq rank's launch (its windows, sliced from the whole
    windowed qkv or handed over already gathered, the tail padded) gives
    the unsharded K3 / K3q launch's rows for those windows; the slices of
    the tables start at offsets the kernel's alignment check would refuse
    uncopied (nW 5 on 2: rank 1 starts at window 3)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    H, S, Lt, D = 2, 100, 7, 128
    vqkv = torch.randn(1, 3, H, nW, S, D, device=cuda, generator=g).bfloat16()
    tqkv = torch.randn(1, 3, H, Lt, D, device=cuda, generator=g).bfloat16()
    ang = torch.rand(nW, S, D, device=cuda, generator=g) * 6
    valid = torch.ones(nW, S, dtype=torch.bool, device=cuda)
    valid[nW // 2, 37:] = False
    norms = 1 + 0.1 * torch.randn(4, D, device=cuda, generator=g)
    tables = (ang.cos(), ang.sin(), ang[0, :Lt].cos(), ang[0, :Lt].sin(), valid, True, norms, True, 1e-5)
    full_v, full_t = k3.fused_window_attention(vqkv, tqkv, *tables, quant_qk=quant_qk)
    counter = "launches_int8" if quant_qk else "launches"
    for rank in range(seq):
        first, end, per = k3.window_range(nW, seq, rank)
        local = k3.pad_windows(vqkv[:, :, :, first:end], 3, per, 0.0)
        for given in (vqkv, local):
            n0 = getattr(k3.fused_window_attention_sharded, counter)
            ov, ot = k3.fused_window_attention_sharded(given, tqkv, *tables, quant_qk=quant_qk, seq_rank=rank,
                                                       seq_size=seq)
            torch.cuda.synchronize()
            assert getattr(k3.fused_window_attention_sharded, counter) == n0 + 1
            assert ov.shape == (1, H, per, S, D) and ot.shape == (1, H, per, Lt, D)
            assert torch.equal(ov[:, :, : end - first], full_v[:, :, first:end])
            assert torch.equal(ot[:, :, : end - first], full_t[:, :, first:end])
            assert bool(torch.isfinite(ov).all()) and bool(torch.isfinite(ot).all())


@pytest.mark.parametrize("S", [463, 64, 37, 128, 129])
def test_flash_attention_kernel_matches_plain(cuda, S):
    """A masked key tail, one batch row with no valid key, q_valid as a tail
    and as a strided row pattern. S = 128 fills the 128-row query tile and
    two 64-key tiles exactly; S = 129 is one row over."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, H, D = 3, 4, 128
    q, k, v = (torch.randn(B, S, H, D, device=cuda, generator=g).bfloat16() for _ in range(3))
    kv_valid = torch.ones(B, S, dtype=torch.bool, device=cuda)
    kv_valid[0, S * 4 // 5 :] = False
    kv_valid[2] = False
    q_valid = torch.ones(B, S, dtype=torch.bool, device=cuda)
    q_valid[1, S // 2 :] = False
    strided = torch.arange(S, device=cuda)[None, :].expand(B, S) % 3 != 1
    n0 = k5.flash_attention.launches
    for qv in (None, strided, q_valid):
        o = k5.flash_attention(q, k, v, kv_valid, qv)
        torch.cuda.synchronize()
        p = k5.flash_attention_plain(q, k, v, kv_valid, qv)
        assert bool(torch.isfinite(o).all())
        assert _rel(o, p) <= REL_BOUND
        assert _rel(o[2], p[2]) <= REL_BOUND  # no valid key: sum(v) / Sp
    assert k5.flash_attention.launches == n0 + 3
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


def test_conv_kernels_reject_what_they_do_not_take(cuda):
    """K1: a Cout that is not a multiple of its 128-column tile; K4: tables
    of the wrong type, shape or device, or only one of them; K6: a Cin that
    is not a multiple of 64, an fp32 input; K2: a C that is not a multiple
    of 64 (its chunk depth); K6 also a Cout that is not a multiple of its
    128-column tile, and views of x or w that are misaligned or at a
    storage offset."""
    x, w, b, scale, shift = _gn_case(cuda, 128, 128, 4, 4, T=1, B=1)
    with pytest.raises(ValueError):
        k1.conv3d_3x3x3(x, w[..., :64].contiguous(), b[:64].contiguous())
    x48 = torch.zeros(1, 2, 3, 3, 48, device=cuda, dtype=torch.bfloat16)
    K48 = torch.zeros(1, 2, 2, 48, 4 * 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k2.fold_upsample_conv(x48, K48, torch.zeros(2, 2, 4 * 48, device=cuda), torch.zeros(48, device=cuda), 1)
    strided = torch.zeros(1, 3, 256, device=cuda)[..., ::2]  # right shape, not contiguous
    for bad in (scale.bfloat16(), scale[:, :2].contiguous(), scale.cpu(), strided):
        with pytest.raises(ValueError):
            k1.conv3d_3x3x3(x, w, b, bad, shift)
    with pytest.raises(ValueError):
        k1.conv3d_3x3x3(x, w, b, scale, None)
    x96 = torch.zeros(1, 3, 4, 4, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k1.conv3d_3x3x3_im2col(x96, torch.zeros(3, 3, 3, 96, 128, device=cuda, dtype=torch.bfloat16), b)
    with pytest.raises(ValueError):
        k1.conv3d_3x3x3_im2col(x.float(), w, b)
    for cout in (64, 192):  # K6's tile is 128 columns wide
        with pytest.raises(ValueError):
            k1.conv3d_3x3x3_im2col(x, w[..., :cout].contiguous(), torch.zeros(cout, device=cuda))
    # contiguous views of a larger buffer: 2 bytes off 16-byte alignment, and
    # aligned but at a storage offset (a TMA map describes a tensor from its base)
    for off in (1, 8):
        buf = torch.zeros(x.numel() + off, device=cuda, dtype=torch.bfloat16)
        view = buf[off:].view(x.shape)
        assert view.is_contiguous() and view.storage_offset() == off
        with pytest.raises(ValueError):
            k1.conv3d_3x3x3_im2col(view, w, b)
    wbuf = torch.zeros(w.numel() + 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k1.conv3d_3x3x3_im2col(x, wbuf[8:].view(w.shape), b)
    assert k1.conv3d_3x3x3_im2col(x, w, b).shape == (1, 1, 4, 4, 128)  # the same tensors, owned, are taken


# K7: M ragged against the 128-row tile (1, 58, 130, 300), several N tiles
# and K steps, with and without a bias; the row-parallel call leaves it out.
# N a multiple of 64 only leaves the last 128-column tile half full (64,
# 192, and 1728 = 6912 / 4: 3B's MLP on a rank of a tensor axis of 4).
K7_CASES = [(1, 128, 64, True), (58, 256, 128, False), (130, 384, 192, True), (300, 128, 640, False),
            (58, 1024, 3072, True), (5, 64, 64, True), (58, 192, 128, False), (300, 1728, 2560, False)]


@pytest.mark.parametrize("M,N,K,bias", K7_CASES)
def test_w8a16_linear_matches_plain(cuda, M, N, K, bias):
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    q = quant.quantize_linear(torch.randn(K, N, generator=g, device=cuda) * K**-0.5)
    w_q, w_s = q["w_q"].t().contiguous(), q["w_s"]
    b = torch.randn(N, generator=g, device=cuda).bfloat16() if bias else None
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    n0 = quant.linear_apply.launches
    y = quant.linear_apply(x, w_q, w_s, b)
    torch.cuda.synchronize()
    assert quant.linear_apply.launches == n0 + 1 and y.shape == (M, N) and y.dtype == torch.bfloat16
    assert _rel(y, quant.linear_apply_plain(x, w_q, w_s, b)) <= REL_BOUND
    exact = (x.float() @ w_q.t().float()) * w_s + (b.float() if bias else 0.0)
    assert _rel(y, exact) <= 4e-3  # one bf16 rounding of the fp32 result
    y3 = quant.linear_apply(x.reshape(1, M, K), w_q, w_s, b)  # leading dims are flattened
    assert torch.equal(y3.reshape(M, N), y)


def test_w8a16_linear_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(4, 128, device=cuda, dtype=torch.bfloat16)
    w_q = torch.zeros(256, 128, device=cuda, dtype=torch.int8)
    w_s = torch.ones(256, device=cuda)
    for args in (
        (x, w_q[:200].contiguous(), w_s[:200]),  # N % 64
        (x[:, :96].contiguous(), w_q[:, :96].contiguous(), w_s),  # K % 64
        (x.float(), w_q, w_s),  # x not bf16
        (x, w_q.float(), w_s),  # w_q not int8
        (x, w_q, w_s.bfloat16()),  # scales not fp32
        (x, w_q.cpu(), w_s),  # another device
        (x, w_q, w_s[:128]),  # scales of another N
        (x[:, ::2], w_q[:, :64].contiguous(), w_s),  # x not contiguous
        (x[:0], w_q, w_s),  # no rows
    ):
        with pytest.raises(ValueError):
            quant.linear_apply(*args)
    with pytest.raises(ValueError):
        quant.linear_apply(x, w_q, w_s, torch.zeros(256, device=cuda))  # fp32 bias
    assert quant.linear_apply(x, w_q, w_s).shape == (4, 256)
