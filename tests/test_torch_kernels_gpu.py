"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at their edges (seedvr2_tpu_torch/conv_ab.py times them and checks
them again at the main paths' shapes).

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

from seedvr2_tpu_torch import conv_ab
from seedvr2_tpu_torch.config import dit_3b, dit_7b
from seedvr2_tpu_torch.ops import conv3d_kernel as k1
from seedvr2_tpu_torch.ops import cuda_lib
from seedvr2_tpu_torch.ops import flash_attention as k5
from seedvr2_tpu_torch.ops import fold_upsample_kernel as k2
from seedvr2_tpu_torch.ops import fused_window_attention as k3
from seedvr2_tpu_torch.ops import mid_attention as k10
from seedvr2_tpu_torch.ops import normalization as norm
from seedvr2_tpu_torch.ops import quant
from seedvr2_tpu_torch.ops import window_prepare as k11

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


# The conv pipeline's edges (csrc/conv_pipeline.cuh): H, W not multiples of
# the 256-pixel patch it picks (9 x 17; W < 16), Cin != Cout (512 -> 256,
# 256 -> 128, 128 -> 256), B = 2 at T = 1, several patches and 128-column
# blocks (33 x 40, Cout 256).
CONV_CASES = [(2, 2, 128, 128, 9, 13), (2, 2, 256, 128, 16, 16), (2, 2, 128, 256, 5, 70), (1, 2, 128, 128, 9, 17),
              (1, 1, 128, 128, 5, 7), (2, 1, 512, 256, 9, 17), (2, 1, 256, 128, 17, 12), (1, 2, 128, 256, 33, 40)]


def _check_conv(cuda, B, T, cin, cout, H, W):
    """K1 against its plain version, the image border and the last frame
    too (TMA's zero fill is the SAME padding); two launches, the same bits."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, T + 2, H, W, cin, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn(cout, device=cuda, generator=g)
    n0 = (k1.conv3d_3x3x3.launches, k1.conv3d_3x3x3.launches_gn)
    y = k1.conv3d_3x3x3(x, w, b)
    torch.cuda.synchronize()
    assert (k1.conv3d_3x3x3.launches, k1.conv3d_3x3x3.launches_gn) == (n0[0] + 1, n0[1])
    ref = k1.conv3d_3x3x3_plain(x, w, b)
    assert bool(torch.isfinite(y).all())
    assert _rel(y, ref) <= REL_BOUND
    border = torch.zeros(H, W, dtype=torch.bool, device=cuda)
    border[0], border[-1], border[:, 0], border[:, -1] = True, True, True, True
    assert _rel(y[:, :, border], ref[:, :, border]) <= REL_BOUND
    assert _rel(y[:, -1], ref[:, -1]) <= REL_BOUND
    assert torch.equal(y, k1.conv3d_3x3x3(x, w, b))


@pytest.mark.parametrize("B,T,cin,cout,H,W", CONV_CASES)
def test_conv3d_kernel_matches_plain(cuda, B, T, cin, cout, H, W):
    _check_conv(cuda, B, T, cin, cout, H, W)


def _gn_case(cuda, cin, cout, H, W, T=3, B=2):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(B, T + 2, H, W, cin, device=cuda, generator=g) * 0.7 + 0.3).bfloat16()
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn(cout, device=cuda, generator=g)
    gw = 1 + 0.2 * torch.randn(cin, device=cuda, generator=g)
    gb = 0.3 * torch.randn(cin, device=cuda, generator=g)
    # the plain tables: K4's cases include Cin 64, which K8 does not take at 32 groups (C / groups = 2)
    scale, shift = k1.gn_silu_tables_plain(x, gw, gb, 32)
    return x, w, b, scale, shift


# K4's own edges beside CONV_CASES: 3 x 100 (all halo rows), 16 x 16 (one
# patch, its halo outside on all four sides), Cin 64 (one stage a tap), W
# below the patch width (20 x 7), a 4 x 64 patch ragged in W (4 x 130), B = 2
# at T = 1 and more tiles than SMs (160 x 160 x 3 frames: the pass runs on
# across tiles).
GN_CASES = CONV_CASES + [(2, 3, 128, 128, 3, 100), (1, 1, 256, 256, 16, 16), (2, 1, 64, 128, 9, 13),
                         (2, 3, 128, 256, 20, 7), (1, 1, 128, 128, 4, 130), (1, 3, 128, 256, 160, 160)]


@pytest.mark.parametrize("B,T,cin,cout,H,W", GN_CASES)
def test_conv3d_gn_kernel_matches_plain(cuda, B, T, cin, cout, H, W):
    """K4. Most cases leave a ragged patch; 5 x 7 and 16 x 16 are one
    patch whose halo crosses the image edge on all four sides, 3 x 100 is
    all halo rows: there the kernel must load zeros, not silu(shift) (which
    the tables make far from 0). Two launches give the same bits."""
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
    assert torch.equal(y, k1.conv3d_3x3x3(x, w, b, scale, shift))


def _check_im2col(cuda, B, T, cin, cout, H, W):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(B, T + 2, H, W, cin, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn(cout, device=cuda, generator=g)
    n0 = (k1.conv3d_3x3x3.launches, k1.conv3d_3x3x3.launches_gn)
    y = k1.conv3d_3x3x3_im2col(x, w, b)
    torch.cuda.synchronize()
    assert (k1.conv3d_3x3x3.launches, k1.conv3d_3x3x3.launches_gn) == (n0[0] + 1, n0[1])  # K6 is a K1 launch
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


@pytest.mark.parametrize("B,T,cin,cout,H,W", IM2COL_CASES)
def test_conv3d_kernel_edges(cuda, B, T, cin, cout, H, W):
    """K1 at K6's tiling edges (the same kernel, through K1's entry)."""
    _check_conv(cuda, B, T, cin, cout, H, W)


@pytest.mark.parametrize("kernel", ["K1/K6", "K4", "K2"])
def test_conv3d_im2col_kernel_resources(cuda, kernel):
    """The conv pipeline's kernels (K1 and K6 share one) launch 384 threads
    with every register the launch bound allows: setmaxnreg then moves them
    from the producer warpgroup (40; K4, whose pass runs there: 72) to the
    two consumers (232; K4: 216), which waits forever if the pool is short.
    No spills, and shared memory within the 227 KB a block may take (K4:
    three slab stages and three weight stages, the others two and six)."""
    a = k2.kernel_attributes() if kernel == "K2" else k1.kernel_attributes(gn=kernel == "K4")
    assert a["registers"] * 384 >= (72 * 128 + 216 * 256 if kernel == "K4" else 40 * 128 + 232 * 256), a
    assert a["local_bytes"] == 0, a
    assert 48 * 1024 < a["smem_bytes"] <= 232448, a


def _check_fold(cuda, kt, A, C, H, W, B=1, Tp=2):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(B, Tp + kt - 1, H, W, C, device=cuda, generator=g).bfloat16()
    K = (torch.randn(kt, 2, 2, C, A * 4 * C, device=cuda, generator=g) / (kt * 4 * C) ** 0.5).bfloat16()
    btab = torch.randn(2, 2, A * 4 * C, device=cuda, generator=g)
    bc = torch.randn(C, device=cuda, generator=g)
    n0 = k2.fold_upsample_conv.launches
    y = k2.fold_upsample_conv(x, K, btab, bc, A)
    torch.cuda.synchronize()
    assert k2.fold_upsample_conv.launches == n0 + 1
    assert y.shape == (B, Tp * A, 2 * H, 2 * W, C) and bool(torch.isfinite(y).all())
    ref = k2.fold_upsample_conv_plain(x, K, btab, bc, A)
    assert _rel(y, ref) <= REL_BOUND
    # the output's border rows and columns: where the bias table is masked
    border = torch.zeros(2 * H, 2 * W, dtype=torch.bool, device=cuda)
    border[:2], border[-2:], border[:, :2], border[:, -2:] = True, True, True, True
    assert _rel(y[:, :, border], ref[:, :, border]) <= REL_BOUND
    assert torch.equal(y, k2.fold_upsample_conv(x, K, btab, bc, A))


@pytest.mark.parametrize("C", [128, 256, 512])
@pytest.mark.parametrize("kt,A", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2)])
def test_fold_upsample_kernel_matches_plain(cuda, kt, A, C):
    """Every (kt, A) the kernel takes at the decoder's widths; H, W odd and
    past one 16 x 16 patch, so the ragged patch and the masked bias table
    at every edge are covered. Two launches give the same bits."""
    _check_fold(cuda, kt, A, C, 19, 17)


# K2's tiling edges: C 64 and 192 (C % 128 == 64: the last channel block's
# upper half is computed and not stored), W below the patch width, a 4 x 64
# patch ragged in W, B = 2 at Tp = 1, and more tiles than SMs.
FOLD_CASES = [(1, 1, 64, 5, 7, 1, 2), (2, 2, 192, 9, 17, 1, 2), (3, 1, 64, 20, 7, 2, 1), (2, 2, 128, 4, 130, 1, 1),
              (3, 2, 256, 40, 70, 1, 1)]


@pytest.mark.parametrize("kt,A,C,H,W,B,Tp", FOLD_CASES)
def test_fold_upsample_kernel_edges(cuda, kt, A, C, H, W, B, Tp):
    _check_fold(cuda, kt, A, C, H, W, B, Tp)


# Window attention corners: the original 3-window case (window 1 ragged), a
# window whose video slots are all invalid (its keys are text only), B = 2,
# no qk norm, R = S + Lt an exact multiple of 128 and one row over, all-zero
# q/k rows (K3q's scale is then 1e-8 and every code 0); and the corners of
# the flash loop's 64-row tiles (csrc/window_attention.cuh): S a multiple of
# 64 and of 128 (the video/text switch on a tile edge, no ragged video
# tile), S = 1, Lt = 1, Lt > 64 (two text key tiles and two text query
# tiles), more (pair, window, head) items than the card has SMs (several
# passes of the persistent grid), and the 3B 720p geometry at H = 2.
_WINDOW_CASES = {
    "True": dict(rope_txt=True),
    "False": dict(rope_txt=False),
    "all_invalid": dict(invalid_window=2),
    "B2": dict(B=2),
    "no_qk_norm": dict(qk_norm=False),
    "R128": dict(S=120, Lt=8, nW=2),
    "R129": dict(S=121, Lt=8, nW=2),
    "zero_rows": dict(zero_rows=True),
    "S64": dict(S=64, Lt=8),
    "S128": dict(S=128, Lt=64, nW=2),
    "S1": dict(S=1, Lt=5),
    "Lt1": dict(Lt=1),
    "Lt65": dict(S=70, Lt=65),
    "waves": dict(nW=80, H=4),
    "3b_720p_H2": dict(nW=18, S=405, Lt=58),
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


def _window_inputs(cuda, rope_txt=True, B=1, nW=3, S=100, Lt=7, qk_norm=True, invalid_window=None, zero_rows=False,
                   H=2, seed=2):
    """(args of fused_window_attention without quant_qk, valid)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    D = 128
    vqkv = torch.randn(B, 3, H, nW, S, D, device=cuda, generator=g).bfloat16()
    tqkv = torch.randn(B, 3, H, Lt, D, device=cuda, generator=g).bfloat16()
    if zero_rows:  # q and k of video slot 5 of window 0 and of text token 1
        vqkv[:, :2, :, 0, 5] = 0
        tqkv[:, :2, :, 1] = 0
    ang = torch.rand(nW, S, D, device=cuda, generator=g) * 6
    tang = torch.rand(Lt, D, device=cuda, generator=g) * 6
    valid = torch.ones(nW, S, dtype=torch.bool, device=cuda)
    valid[1, 60 if S > 60 else S // 2:] = False  # ragged window
    if invalid_window is not None:
        valid[invalid_window] = False
    norms = 1 + 0.1 * torch.randn(4, D, device=cuda, generator=g)
    return (vqkv, tqkv, ang.cos(), ang.sin(), tang.cos(), tang.sin(), valid, rope_txt, norms, qk_norm, 1e-5), valid


def _check_window_attention(cuda, quant_qk, zero_rows=False, invalid_window=None, **case):
    args, valid = _window_inputs(cuda, zero_rows=zero_rows, invalid_window=invalid_window, **case)
    args = (*args, quant_qk)
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
def test_window_attention_two_launches_give_the_same_bits(cuda, quant_qk):
    """No atomics and a fixed order of operations: the same inputs, the same
    bits (the 3B 720p shifted geometry at H = 4: several passes of the
    persistent grid)."""
    args, _ = _window_inputs(cuda, nW=32, S=405, Lt=58, H=4)
    first = k3.fused_window_attention(*args, quant_qk=quant_qk)
    second = k3.fused_window_attention(*args, quant_qk=quant_qk)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("quant_qk", [False, True])
@pytest.mark.parametrize("case", ["True", "False", "no_qk_norm", "all_invalid", "Lt65", "S1"])
def test_window_qk_prepare_matches_the_plain_intermediates(cuda, case, quant_qk):
    """The preparation kernel against qk_prepare_plain. K3's bf16 rows: the
    kernel sums the rms in its own order (fp32, like any reduction on the
    card), so a bf16 rounding may go the other way: at most 1e-3 of the
    elements may differ, each by at most one bf16 step of its row's largest
    value. K3q's int8 codes and fp32 scales equal quantize_rows of the K3
    rows exactly (the same fp32 operations in the same order). The padding
    of the scales, the key codes and the key-tile flags are checked
    exactly."""
    args, valid = _window_inputs(cuda, **_WINDOW_CASES[case])
    vqkv, tqkv, vcos, vsin, tcos, tsin, _, rope_txt, norms, qk_norm, eps = args
    lib = cuda_lib.library()
    rows = k3.qk_prepare(lib, *args, False)
    torch.cuda.synchronize()
    plain = k3.qk_prepare_plain(vqkv, tqkv, vcos, vsin, tcos, tsin, rope_txt, norms, qk_norm, eps)
    for got, ref in zip(rows[:4], plain):
        step = ref.float().abs().amax(-1, keepdim=True) * 2.0**-7
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= step).all())
        assert float((diff != 0).float().mean()) <= 1e-3
    S, Lt = vqkv.shape[4], tqkv.shape[3]
    Sp = -(-S // k3.TILE) * k3.TILE
    code = torch.full((valid.shape[0], Sp), float("-inf"), device=cuda)
    code[:, :S] = torch.where(valid, 0.0, float("-inf"))
    assert torch.equal(rows.kcode, code)
    live = (code == 0).view(code.shape[0], -1, k3.TILE).any(-1)
    assert torch.equal(rows.tile_live.bool(), live)
    if quant_qk:
        prep = k3.qk_prepare(lib, *args, True)
        torch.cuda.synchronize()
        assert torch.equal(prep.kcode, code) and torch.equal(prep.tile_live.bool(), live)
        for got, bf, scale, n in zip(prep[:4], rows[:4], prep[4:8], (S, S, Lt, Lt)):
            codes, s = k3.quantize_rows(bf)
            assert got.dtype == torch.int8 and torch.equal(got.float(), codes)
            assert torch.equal(scale[..., :n], s[..., 0])
            assert bool((scale[..., n:] == 0).all())


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


# K5 on the attention pipeline (csrc/flash_attention.cuh): the 3B and 7B
# head counts, more work items than the card has SMs (B = 32 windows of 24
# heads, 4 query blocks each), and key tiles skipped for their masks: valid
# keys behind a fully masked 64-key tile, a masked tile between valid ones,
# the last tiles masked (the item's last read of Q is then an earlier tile);
# one batch row with no valid key in each case (nothing skipped there).
FLASH_CASES = [(3, 463, 20, "behind a masked tile"), (3, 463, 24, "between"), (32, 463, 24, "windows"),
               (4, 200, 4, "last tiles masked"), (2, 129, 2, "behind a masked tile")]


@pytest.mark.parametrize("B,S,H,case", FLASH_CASES)
def test_flash_attention_kernel_skips_masked_tiles(cuda, B, S, H, case):
    """Against the plain version (rel L2 <= 1e-2, each batch row too),
    q_valid zeroing its rows, and two launches with the same bits."""
    g = torch.Generator(device=cuda).manual_seed(7)
    D = 128
    q, k, v = (torch.randn(B, S, H, D, device=cuda, generator=g).bfloat16() for _ in range(3))
    kv_valid = torch.ones(B, S, dtype=torch.bool, device=cuda)
    if case == "behind a masked tile":
        kv_valid[0, :64] = False
        kv_valid[1, : S - 3] = False  # three valid keys at the end
    elif case == "between":
        kv_valid[0, 64:192] = False
        kv_valid[1, 128:] = False
    elif case == "windows":  # padded window slots, then the always-valid text keys
        slots = torch.arange(S, device=cuda)[None, :]
        kv_valid &= (slots >= 405) | (slots < 405 - 6 * torch.arange(B, device=cuda)[:, None])
    else:
        kv_valid[:, 128:] = False
    kv_valid[-1] = False
    q_valid = torch.arange(S, device=cuda)[None, :].expand(B, S) % 5 != 2
    n0 = k5.flash_attention.launches
    for qv in (None, q_valid):
        o = k5.flash_attention(q, k, v, kv_valid, qv)
        torch.cuda.synchronize()
        p = k5.flash_attention_plain(q, k, v, kv_valid, qv)
        assert bool(torch.isfinite(o).all())
        assert _rel(o, p) <= REL_BOUND
        for b in range(B):
            assert _rel(o[b], p[b]) <= REL_BOUND
        assert torch.equal(o, k5.flash_attention(q, k, v, kv_valid, qv))
    assert k5.flash_attention.launches == n0 + 4
    assert not bool(o[~q_valid].any())


def test_flash_attention_kernel_resources(cuda):
    """K5's kernel: no spills, the shared memory of K3's flash loop."""
    a = k5.kernel_attributes()
    assert a["local_bytes"] == 0, a
    assert 48 * 1024 < a["smem_bytes"] <= 232448, a


# K11 (csrc/window_prepare.cuh) at the plans it serves, 58 text tokens: the 7B's window_pixel plan at the
# 720p latent, plain and shifted (ragged last windows; video roped on 60 of 128 dims, text not roped); the 3B's
# mmrope3d plan, as a 3B runs under flash_attn_2 (text roped), with a bias in q, k, v (an offset a channel, as
# a projection with qk_bias gives); the qk norm off; a seq rank's local index with padding windows (the 3B plain
# plan's 18 windows on seq 4: rank 3 holds windows 15-17, then two padding windows that read token 0, their
# tables angle 0) and one without (seq 2: rank 1's windows 9-17 start 9 x 405 int64 into the plan's index, an
# offset not 16-byte aligned); B = 2 at 6 heads (a partial group of the kernel's 4 heads a block).
K11_CASES = {
    "7b_plain": dict(variant="7b", shifted=False),
    "7b_shifted": dict(variant="7b", shifted=True),
    "3b_mmrope3d_bias": dict(variant="3b", shifted=True, bias=True),
    "no_qk_norm": dict(variant="7b", shifted=False, qk_norm=False),
    "seq_rank_padding": dict(variant="3b", shifted=False, seq=(3, 4)),
    "seq_rank_offset": dict(variant="3b", shifted=False, seq=(1, 2)),
    "B2_H6": dict(variant="7b", shifted=True, B=2, H=6),
}


def _k11_inputs(cuda, variant, shifted, qk_norm=True, seq=None, B=1, H=None, bias=False, Lt=58):
    """The arguments of window_prepare at a plan of the 3B or 7B at the 720p
    latent (2, 45, 80)."""
    from seedvr2_tpu_torch.models.dit.nadit import NaDiT, build_attn_plans, device_plans

    cfg = dit_7b() if variant == "7b" else dit_3b()
    H, D = H or cfg.heads, cfg.head_dim
    dp = device_plans(build_attn_plans(cfg, (2, 45, 80), Lt), D, cuda)[int(shifted)]
    g = torch.Generator(device=cuda).manual_seed(5)
    y = torch.randn(B, dp.inverse.numel(), 3, H, D, device=cuda, generator=g)
    t = torch.randn(B, Lt, 3, H, D, device=cuda, generator=g)
    if bias:
        offset = torch.randn(3, H, D, device=cuda, generator=g)
        y, t = y + offset, t + offset
    norms = 1 + 0.1 * torch.randn(4, D, device=cuda, generator=g)
    index, cos, sin = dp.index, dp.vid_cos, dp.vid_sin
    if seq is not None:
        rank, size = seq
        first, end, per = k3.window_range(dp.valid.shape[0], size, rank)
        index = NaDiT._local_index(dp, first, end, per)
        cos, sin, _ = k3.shard_window_tables(dp.vid_cos, dp.vid_sin, dp.valid, rank, size)
    return (y.bfloat16(), t.bfloat16(), index, cos, sin, dp.txt_cos, dp.txt_sin, dp.rope_txt, norms, qk_norm,
            cfg.norm_eps)


@pytest.mark.parametrize("case", list(K11_CASES))
def test_window_prepare_kernel_matches_plain(cuda, case):
    """K11 against its plain version (the unfused route's own ops, on the
    card). q and k: the kernel sums each row's squares in its own order
    (fp32, like any reduction on the card), so where the rms lands on the
    other side of a rounding boundary a bf16 code moves: at most 1e-3 of
    the elements may differ, each by at most one bf16 step of its row's
    largest value; with the qk norm off nothing is summed and the bits are
    equal. v: the same bits. Every window of a batch holds the same text
    rows."""
    args = _k11_inputs(cuda, **K11_CASES[case])
    n0 = k11.window_prepare.launches
    got = k11.window_prepare(*args)
    torch.cuda.synchronize()
    assert k11.window_prepare.launches == n0 + 1
    ref = k11.window_prepare_plain(*args)
    qk_norm = args[9]
    for a, b in zip(got[:2], ref[:2]):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16 and a.is_contiguous()
        if not qk_norm:
            assert torch.equal(a, b)
        step = b.float().abs().amax(-1, keepdim=True) * 2.0**-7
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= step).all())
        assert float((diff != 0).float().mean()) <= 1e-3
    assert torch.equal(got[2], ref[2])
    B, (per, mL) = args[0].shape[0], args[3].shape[:2]
    for x in got:
        txt = x.view(B, per, *x.shape[1:])[:, :, mL:]
        assert torch.equal(txt, txt[:, :1].expand_as(txt))


def test_window_prepare_two_launches_give_the_same_bits(cuda):
    args = _k11_inputs(cuda, "7b", True)
    first = k11.window_prepare(*args)
    second = k11.window_prepare(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_window_prepare_kernel_does_not_spill(cuda):
    lines = [line for _, line in cuda_lib.ptxas_lines(cuda_lib.build().log, "window_prepare_kernel")]
    spills = [line for line in lines if "spill" in line]
    assert spills and all("0 bytes spill stores, 0 bytes spill loads" in line for line in spills), lines


def test_window_prepare_rejects_what_it_does_not_take(cuda):
    """fp32 or strided qkv, head dim 64, an int32 index, an index of
    another length, tables of another window count, fp32 text."""
    y, t, index, cos, sin, tcos, tsin, rope_txt, norms, qk_norm, eps = args = _k11_inputs(cuda, "7b", False, H=2)
    wide = torch.zeros(*y.shape[:-1], 256, device=cuda, dtype=torch.bfloat16)
    for bad in ((y.float(), t, index, cos, sin), (wide[..., ::2], t, index, cos, sin),
                (y[..., :64].contiguous(), t[..., :64].contiguous(), index, cos[..., :64].contiguous(),
                 sin[..., :64].contiguous()),
                (y, t, index.int(), cos, sin), (y, t, index[:-1], cos, sin), (y, t, index, cos[1:], sin[1:]),
                (y, t.float(), index, cos, sin)):
        with pytest.raises(ValueError):
            k11.window_prepare(*bad, tcos, tsin, rope_txt, norms, qk_norm, eps)
    assert k11.window_prepare(*args)[0].shape == (cos.shape[0], cos.shape[1] + t.shape[1], 2, 128)


# K10 (csrc/mid_attention.cuh) at the released VAE's width: a video1080 batch's two latent frames of
# 135 x 240 pixels, a 1440 x 2560 image's 180 x 320, a 720p batch's two of 90 x 160 and a 1080p decode
# tile's two of 76 x 128 (1024 px tiles); at the small config's width a ragged n (64 query tiles and one
# row, 128 key tiles and one key)
K10_CASES = [(2, 32400, 512), (1, 57600, 512), (2, 14400, 512), (2, 9728, 512), (1, 4097, 256)]


@pytest.mark.parametrize("F,n,C", K10_CASES)
def test_mid_attention_kernel_matches_plain(cuda, F, n, C):
    """Against the plain version on fp32 copies of the same bf16 inputs
    (rel L2 <= 1e-2, each frame), one launch a call, two launches with the
    same bits."""
    g = torch.Generator(device=cuda).manual_seed(n)
    q, k, v = (torch.randn(F, n, C, device=cuda, generator=g).bfloat16() for _ in range(3))
    n0 = k10.mid_attention.launches
    o = k10.mid_attention(q, k, v)
    torch.cuda.synchronize()
    assert k10.mid_attention.launches == n0 + 1
    assert bool(torch.isfinite(o).all())
    for f in range(F):
        ref = k10.mid_attention_plain(q[f:f + 1].float(), k[f:f + 1].float(), v[f:f + 1].float())
        assert _rel(o[f], ref[0]) <= REL_BOUND, f
        del ref
    assert torch.equal(o, k10.mid_attention(q, k, v))
    assert k10.mid_attention.launches == n0 + 2


@pytest.mark.parametrize("C", k10.WIDTHS)
def test_mid_attention_kernel_resources(cuda, C):
    """K10's kernel at each width: no spills, shared memory opted in above
    48 KB and within the 227 KB a block may have."""
    a = k10.kernel_attributes(C)
    assert a["local_bytes"] == 0, a
    assert 48 * 1024 < a["smem_bytes"] <= 232448, a


# K8 (csrc/gn_stats.cuh) against fp64: the VAE's widths at 32 groups (one
# frame above a chunk: 33 x 47 = 1551 pixels against 1024 at C = 128), the
# GN_SHAPES of tests/test_torch_conv_kernels.py at 32 and 4 groups
# ((C / groups) % 4 == 0 in each), H * W not a multiple of the chunk, B * T
# frames of several chunks.
GN_STATS_CASES = [(1, 3, 33, 47, 128, 32), (1, 3, 30, 40, 256, 32), (2, 2, 20, 31, 512, 32),
                  (1, 5, 16, 256, 128, 32), (2, 4, 10, 130, 256, 32), (1, 3, 9, 17, 128, 32), (2, 3, 5, 7, 256, 32),
                  (1, 3, 6, 10, 512, 32), (1, 4, 9, 17, 128, 32), (1, 5, 16, 256, 128, 4), (2, 4, 10, 130, 256, 4),
                  (1, 3, 6, 10, 512, 4), (1, 7, 150, 97, 128, 32)]


def _tables_case(cuda, B, Tt, H, W, C, seed, offset=0.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(B, Tt, H, W, C, device=cuda, generator=g) + offset).bfloat16()
    gw = 1 + 0.2 * torch.randn(C, device=cuda, generator=g)
    gb = 0.3 * torch.randn(C, device=cuda, generator=g)
    return x, gw, gb


@pytest.mark.parametrize("B,Tt,H,W,C,groups", GN_STATS_CASES)
def test_gn_stats_kernel_matches_fp64(cuda, B, Tt, H, W, C, groups):
    """Scale and shift within 1e-6 (max |k - ref| / max |ref|) of fp64, and
    near the plain version; one count a call; two launches, the same bits."""
    x, gw, gb = _tables_case(cuda, B, Tt, H, W, C, 8)
    n0 = k1.gn_silu_tables.launches
    got = k1.gn_silu_tables(x, gw, gb, groups)
    torch.cuda.synchronize()
    assert k1.gn_silu_tables.launches == n0 + 1
    ref = conv_ab.tables_fp64(x, gw, gb, groups)
    plain = k1.gn_silu_tables_plain(x, gw, gb, groups)
    for a, r, p in zip(got, ref, plain):
        assert a.shape == (B, Tt, C) and a.dtype == torch.float32
        assert conv_ab.max_rel(a, r) <= 1e-6
        assert conv_ab.max_rel(a, p.double()) <= 2e-6
    again = k1.gn_silu_tables(x, gw, gb, groups)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the VAE's norm weights are bf16: the same tables from their values
    gwb, gbb = gw.bfloat16(), gb.bfloat16()
    for a, r in zip(k1.gn_silu_tables(x, gwb, gbb, groups), conv_ab.tables_fp64(x, gwb.float(), gbb.float(), groups)):
        assert conv_ab.max_rel(a, r) <= 1e-6


@pytest.mark.parametrize("C", [128, 256, 512])
def test_gn_stats_kernel_offset_mean(cuda, C):
    """8 + N(0, 1) in bf16 (E[x^2] - E[x]^2 would lose ~8 bits): within
    1e-6 of fp64 and no more than 2x the plain version's own error; then K4
    on these tables against K4 on the plain tables."""
    x, gw, gb = _tables_case(cuda, 1, 4, 64, 96, C, 9, offset=8.0)
    got = k1.gn_silu_tables(x, gw, gb, 32)
    ref = conv_ab.tables_fp64(x, gw, gb, 32)
    plain = k1.gn_silu_tables_plain(x, gw, gb, 32)
    for a, r, p in zip(got, ref, plain):
        err, plain_err = conv_ab.max_rel(a, r), conv_ab.max_rel(p, r)
        assert err <= 1e-6 and err <= 2 * plain_err, (err, plain_err)
    g = torch.Generator(device=cuda).manual_seed(10)
    w = (torch.randn(3, 3, 3, C, 128, device=cuda, generator=g) / (27 * C) ** 0.5).bfloat16()
    b = torch.randn(128, device=cuda, generator=g)
    y = k1.conv3d_3x3x3(x, w, b, *got)
    assert _rel(y, k1.conv3d_3x3x3(x, w, b, *plain)) <= REL_BOUND
    assert _rel(y, k1.conv3d_3x3x3_plain(x, w, b, *plain)) <= REL_BOUND


# K9 (csrc/gn_apply.cuh): the VAE's GroupNorm shapes on the card (x of the
# 720p resnets c512 5x180x320, c256 7x360x640, c128 7x720x1280; the
# decoder's norm_out c128 5x720x1280; the encoder's norm_out and the mid
# attention c512 2x90x160; the long clip's tiles c128 5x608x1024, c256
# 5x304x512), then ragged ones: H * W not a multiple of a block's pixels,
# B * T > 1, a single pixel, C 8 and 1024 (K9 alone: K8 takes C / groups a
# multiple of 4).
GN_APPLY_PATH = [(1, 5, 180, 320, 512), (1, 7, 360, 640, 256), (1, 7, 720, 1280, 128), (1, 5, 720, 1280, 128),
                 (1, 2, 90, 160, 512), (1, 5, 608, 1024, 128), (1, 5, 304, 512, 256)]
GN_APPLY_RAGGED = [(2, 3, 9, 17, 128), (3, 2, 13, 7, 256), (2, 2, 5, 3, 512), (1, 1, 1, 1, 512), (2, 3, 33, 31, 1024),
                   (1, 2, 3, 5, 8)]


def _gn_apply_case(cuda, B, T, H, W, C, groups=32):
    """x, the VAE's bf16 norm weights, K8's tables of x (K8 where it takes
    C, else the plain tables) and |x * scale| + |shift| (conv_ab.gn_codes)."""
    x, gw, gb = _tables_case(cuda, B, T, H, W, C, C + H)
    gw, gb = gw.bfloat16(), gb.bfloat16()
    tables = k1.gn_silu_tables if (C // groups) % 4 == 0 and C % groups == 0 else k1.gn_silu_tables_plain
    scale, shift = tables(x, gw, gb, min(groups, C))
    mag = (x.float() * scale[:, :, None, None, :]).abs() + shift[:, :, None, None, :].abs()
    return x, gw, gb, scale, shift, mag


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("B,T,H,W,C", GN_APPLY_PATH + GN_APPLY_RAGGED)
def test_gn_apply_kernel_matches_plain(cuda, B, T, H, W, C, silu):
    """K9 against gn_apply_plain on K8's tables: without the SiLU to the bit
    (a rounded multiply and add, then bf16, on both sides); with it, no
    code more than one step away and at most 1e-3 of them moved (the
    normalised codes agree; __expf against expf moves a code at a tie);
    rel L2 <= 1e-2; one count a call; two launches, the same bits."""
    x, gw, gb, scale, shift, mag = _gn_apply_case(cuda, B, T, H, W, C)
    n0 = norm.gn_apply.launches
    got = norm.gn_apply(x, scale, shift, silu)
    torch.cuda.synchronize()
    assert norm.gn_apply.launches == n0 + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    plain = norm.gn_apply_plain(x, scale, shift, silu)
    if silu:
        steps = conv_ab.bf16_steps(got, plain)
        assert int(steps.max()) <= 1 and float((steps > 0).float().mean()) <= 1e-3
    else:
        assert torch.equal(got, plain)
    assert _rel(got, plain) <= REL_BOUND
    assert torch.equal(got, norm.gn_apply(x, scale, shift, silu))


@pytest.mark.parametrize("B,T,H,W,C", GN_APPLY_PATH[:5] + GN_APPLY_RAGGED[:3])
def test_group_norm_frames_kernels_match_the_plain_route(cuda, B, T, H, W, C):
    """The VAE's wrapper on the card (K8, then K9; one count each a call)
    against its plain route on the same tensors (GroupNorm, bf16, SiLU in
    fp32, bf16): conv_ab.gn_codes's rule, at most 1e-3 of the codes moved,
    the bound tests/test_torch_gn_apply.py holds K8 + K9's arithmetic to
    against the JAX package. A strided x is taken (made contiguous first)."""
    x, gw, gb, _, _, mag = _gn_apply_case(cuda, B, T, H, W, C)
    n0 = (k1.gn_silu_tables.launches, norm.gn_apply.launches)
    pre, out = (norm.group_norm_frames(x, gw, gb, 32, silu) for silu in (False, True))
    torch.cuda.synchronize()
    assert (k1.gn_silu_tables.launches, norm.gn_apply.launches) == (n0[0] + 2, n0[1] + 2)
    ref_pre, ref_out = (norm.group_norm_frames_plain(x, gw, gb, 32, silu) for silu in (False, True))
    codes = conv_ab.gn_codes(pre, ref_pre, mag, out, ref_out)
    assert codes["far"] == 0 and codes["share"] <= 1e-3 and codes["pre_share"] <= 1e-3, codes
    strided = torch.empty(B, T, H, W, 2 * C, device=cuda, dtype=torch.bfloat16)[..., ::2]
    strided.copy_(x)
    assert torch.equal(norm.group_norm_frames(strided, gw, gb, 32, True), out)


def test_vae_runs_every_group_norm_on_the_kernels(cuda):
    """A 128 / 256-channel VAE (chip_smoke.py's small config) encoding and
    decoding 5 frames on each route: unfused, K8 = K9 = the resnets'
    GroupNorms (K1's count) + norm_out and the mid attention's in each half;
    with GN fusion, K8 = K4 + K9 and K9 = those four; on both, the mid
    attention of each half on K10 (C = 256). Both routes within the card
    checks' bound of each other."""
    from seedvr2_tpu_torch.config import VAEConfig
    from seedvr2_tpu_torch.models.params import init_random
    from seedvr2_tpu_torch.models.vae.causal_conv import StreamCtx
    from seedvr2_tpu_torch.models.vae.model import VAE

    vc = VAEConfig(block_out_channels=(128, 128, 256, 256), layers_per_block=1)
    vae = init_random(VAE(vc, cuda, torch.bfloat16), torch.Generator(device=cuda).manual_seed(12))
    x = torch.rand(1, 5, 32, 48, 3, generator=torch.Generator(device=cuda).manual_seed(13), device=cuda).bfloat16()
    outs, counts = [], []
    for fusion in (False, True):
        vae.set_gn_fusion(fusion)
        n0 = [k1.conv3d_3x3x3.launches, k1.conv3d_3x3x3.launches_gn, k1.gn_silu_tables.launches,
              norm.gn_apply.launches, k10.mid_attention.launches]
        z = vae.encoder(x, StreamCtx("disabled"))[..., : vc.latent_channels].contiguous()
        outs.append(vae.decoder(z, StreamCtx("disabled")).float())
        torch.cuda.synchronize()
        counts.append([a - b for a, b in zip([k1.conv3d_3x3x3.launches, k1.conv3d_3x3x3.launches_gn,
                                              k1.gn_silu_tables.launches, norm.gn_apply.launches,
                                              k10.mid_attention.launches], n0)])
    resnet_gn = 2 * vc.layers_per_block * vc.num_blocks + 2 * (vc.layers_per_block + 1) * vc.num_blocks + 8
    assert counts[0] == [resnet_gn, 0, resnet_gn + 4, resnet_gn + 4, 2], counts
    assert counts[1] == [0, resnet_gn, resnet_gn + 4, 4, 2], counts
    assert _rel(outs[1], outs[0]) <= 5e-2


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
    # K10: fp32 q, a width it has no instance for, k of another shape, a strided v, a 4-D q
    q = torch.zeros(2, 70, 512, device=cuda, dtype=torch.bfloat16)
    strided = torch.zeros(2, 70, 1024, device=cuda, dtype=torch.bfloat16)[..., ::2]
    for args in ((q.float(), q, q), (q[..., :384].contiguous(),) * 3, (q, q[:, :64].contiguous(), q), (q, q, strided),
                 (q[None], q[None], q[None])):
        with pytest.raises(ValueError):
            k10.mid_attention(*args)
    # K8: fp32 x, a view 2 bytes off 16-byte alignment, C / groups = 2 or
    # not a multiple of 4, fp16 or mixed norm weights
    x, gw, gb = _tables_case(cuda, 1, 3, 4, 5, 128, 0)
    buf = torch.zeros(x.numel() + 1, device=cuda, dtype=torch.bfloat16)
    view = buf[1:].view(x.shape)
    for args in ((x.float(), gw, gb, 32), (view, gw, gb, 32), (x, gw, gb, 64),
                 (x[..., :96].contiguous(), gw[:96].contiguous(), gb[:96].contiguous(), 16),
                 (x, gw.half(), gb.half(), 32), (x, gw, gb.bfloat16(), 32)):
        with pytest.raises(ValueError):
            k1.gn_silu_tables(*args)
    # K9: fp32 x, a view 2 bytes off 16-byte alignment, a strided x, C not a
    # multiple of 8, tables in bf16, of another shape or strided; its
    # wrapper at C / groups = 2 (K8 refuses it)
    scale, shift = k1.gn_silu_tables(x, gw, gb, 32)
    strided = torch.zeros(1, 3, 256, device=cuda)[..., ::2]
    x12 = torch.zeros(1, 3, 4, 5, 12, device=cuda, dtype=torch.bfloat16)
    t12 = torch.zeros(1, 3, 12, device=cuda)
    for args in ((x.float(), scale, shift), (view, scale, shift), (x.transpose(2, 3), scale, shift),
                 (x12, t12, t12), (x, scale.bfloat16(), shift), (x, scale, shift[:, :2].contiguous()),
                 (x, strided, shift)):
        with pytest.raises(ValueError):
            norm.gn_apply(*args, True)
    with pytest.raises(ValueError):
        norm.group_norm_frames(x, gw, gb, 64, True)


def test_conv_kernels_reject_what_they_do_not_take(cuda):
    """K1 and K6 (one kernel): a Cin that is not a multiple of 64 (its
    stage depth), a Cout that is not a multiple of its 128-column tile, an
    fp32 input; K4: tables of the wrong type, shape or device, or only one
    of them; K2: a C that is not a multiple of 64. Views of x or w at a
    storage offset are taken as they are when their data pointer is
    16-byte aligned (the TMA maps are encoded from it) and refused when it
    is not."""
    x, w, b, scale, shift = _gn_case(cuda, 128, 128, 4, 4, T=1, B=1)
    with pytest.raises(ValueError):
        k1.conv3d_3x3x3(x, w[..., :64].contiguous(), b[:64].contiguous())
    x96 = torch.zeros(1, 3, 4, 4, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k1.conv3d_3x3x3(x96, torch.zeros(3, 3, 3, 96, 128, device=cuda, dtype=torch.bfloat16), b)
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
    # contiguous views of a larger buffer: 2 bytes off 16-byte alignment
    # (refused), and 16 bytes in (taken, as the time slices of a streamed
    # conv's extended input are: the same result as the owned tensors)
    want = k1.conv3d_3x3x3(x, w, b)
    want_gn = k1.conv3d_3x3x3(x, w, b, scale, shift)
    for off in (1, 8):
        buf = torch.zeros(x.numel() + off, device=cuda, dtype=torch.bfloat16)
        view = buf[off:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.storage_offset() == off
        wbuf = torch.zeros(w.numel() + off, device=cuda, dtype=torch.bfloat16)
        wview = wbuf[off:].view(w.shape)
        wview.copy_(w)
        calls = (lambda: k1.conv3d_3x3x3(view, w, b), lambda: k1.conv3d_3x3x3(x, wview, b),
                 lambda: k1.conv3d_3x3x3_im2col(view, w, b), lambda: k1.conv3d_3x3x3_im2col(x, wview, b))
        for call in calls:
            if off == 1:
                with pytest.raises(ValueError):
                    call()
            else:
                assert torch.equal(call(), want)
        if off == 8:
            assert torch.equal(k1.conv3d_3x3x3(view, w, b, scale, shift), want_gn)
    xf = torch.randn(1, 2, 3, 5, 64, device=cuda).bfloat16()
    Kf = torch.randn(2, 2, 2, 64, 256, device=cuda).bfloat16()
    bt, bcf = torch.randn(2, 2, 256, device=cuda), torch.randn(64, device=cuda)
    fbuf = torch.zeros(xf.numel() + 8, device=cuda, dtype=torch.bfloat16)
    fview = fbuf[8:].view(xf.shape)
    fview.copy_(xf)
    assert torch.equal(k2.fold_upsample_conv(fview, Kf, bt, bcf, 1), k2.fold_upsample_conv(xf, Kf, bt, bcf, 1))
    with pytest.raises(ValueError):
        k2.fold_upsample_conv(fbuf[1:-7].view(xf.shape), Kf, bt, bcf, 1)


# K7: both regimes on each side of the row threshold (quant.TEXT_ROWS = 64:
# split-K at M 1, 5, 58, 64; wgmma from 65), M ragged against the 240-row
# tile (65, 128, 129, 130, 300, 7200), several N tiles and K steps, with and
# without a bias (the row-parallel call leaves it out). N a multiple of 64
# only leaves the last 128-column tile half full (64, 192, and 1728 = 6912
# / 4: 3B's MLP on a rank of a tensor axis of 4, whose proj_out has K 1728);
# the full-width 7B proj_out (K 12288, N 3072) at the text and video rows.
K7_CASES = [(1, 128, 64, True), (58, 256, 128, False), (130, 384, 192, True), (300, 128, 640, False),
            (58, 1024, 3072, True), (5, 64, 64, True), (58, 192, 128, False), (300, 1728, 2560, False),
            (64, 256, 128, True), (65, 256, 128, False), (128, 384, 192, True), (129, 192, 256, False),
            (7200, 2560, 2560, True), (58, 3072, 12288, True), (7200, 3072, 12288, True), (1, 3072, 12288, False),
            (58, 1728, 1728, False), (7200, 1728, 1728, True), (7200, 2560, 1728, False)]


@pytest.mark.parametrize("M,N,K,bias", K7_CASES)
def test_w8a16_linear_matches_plain(cuda, M, N, K, bias):
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    q = quant.quantize_linear(torch.randn(K, N, generator=g, device=cuda) * K**-0.5)
    w_q, w_s = q["w_q"].t().contiguous(), q["w_s"]
    b = torch.randn(N, generator=g, device=cuda).bfloat16() if bias else None
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    kind = quant.regime(M)
    assert kind == ("splitk" if M <= 64 else "wgmma")
    n0, r0 = quant.linear_apply.launches, getattr(quant.linear_apply, f"launches_{kind}")
    s0 = quant.linear_apply.launches_by_shape.get((M, K, N), 0)
    y = quant.linear_apply(x, w_q, w_s, b)
    torch.cuda.synchronize()
    assert quant.linear_apply.launches == n0 + 1 and y.shape == (M, N) and y.dtype == torch.bfloat16
    assert getattr(quant.linear_apply, f"launches_{kind}") == r0 + 1  # the regime of M was taken
    assert quant.linear_apply.launches_by_shape[(M, K, N)] == s0 + 1
    assert _rel(y, quant.linear_apply_plain(x, w_q, w_s, b)) <= REL_BOUND
    exact = (x.float() @ w_q.t().float()) * w_s + (b.float() if bias else 0.0)
    assert _rel(y, exact) <= 4e-3  # one bf16 rounding of the fp32 result
    assert torch.equal(quant.linear_apply(x, w_q, w_s, b), y)  # the same bits on a second launch
    y3 = quant.linear_apply(x.reshape(1, M, K), w_q, w_s, b)  # leading dims are flattened
    assert torch.equal(y3.reshape(M, N), y)


@pytest.mark.parametrize("variant", ["3b", "7b"])
def test_k7_splits_fill_the_card_with_the_fewest_splits(cuda, variant):
    """Every int8 linear of each tensor split: N / 128 x splits reaches two
    blocks an SM with the fewest splits, or K has no more 64-deep steps to
    split; every split has at least one step. On a 132-SM card: 7B
    proj_out 24 n-tiles x 11, 3B out 20 x 14, 7B proj_in 96 x 3, and K of
    one step (64) unsplit."""
    lib, index = cuda_lib.library(), torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    cfg = dit_3b() if variant == "3b" else dit_7b()
    for name, K, N, _ in conv_ab.int8_linear_shapes(cfg):
        for tensor in (1, 2, 4):
            n, k = (N, K // tensor) if name in ("out", "proj_out") else (N // tensor, K)
            s, tiles = quant.splits(lib, index, n, k), -(-n // 128)
            assert 1 <= s <= k // 64, (name, tensor)
            assert tiles * s >= 2 * sms or s == k // 64, (name, tensor, s)
            assert s == 1 or tiles * (s - 1) < 2 * sms, (name, tensor, s)
    if sms == 132:
        got = [quant.splits(lib, index, n, k) for n, k in ((3072, 12288), (2560, 2560), (12288, 3072), (128, 64))]
        assert got == [11, 14, 3, 1]


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


def test_int8_7b_forward_runs_every_block_linear_on_k7(cuda):
    """One NaDiT-7B forward with int8 block linears (random weights) at the
    image mix's smallest size, a 512 x 512 image upscaled 2x (latent 1 x 128
    x 128: 4,096 video rows), with the 58 text rows: 36 layers x 2 streams x
    (qkv, out, 2 MLP) = 288 K7 launches, the video rows on wgmma, the text
    rows on split-K; under flash_attn_2 one K11 and one K5 launch a layer."""
    from seedvr2_tpu_torch.io.weights import random_dit
    from seedvr2_tpu_torch.models.dit.nadit import build_attn_plans, device_plans

    cfg = dit_7b()
    g = torch.Generator(device=cuda).manual_seed(0)
    dit = random_dit(cfg, g, torch.bfloat16, quantize="int8").set_attention_mode("flash_attn_2")
    vid = torch.randn(1, 1, 128, 128, cfg.vid_in_channels, device=cuda, generator=g).bfloat16()
    txt = torch.randn(1, 58, cfg.txt_in_dim, device=cuda, generator=g).bfloat16()
    plans = device_plans(build_attn_plans(cfg, (1, 64, 64), 58), cfg.head_dim, cuda)
    quant.reset_launches()
    k11.window_prepare.launches = k5.flash_attention.launches = 0
    with torch.inference_mode():
        out = dit(vid, txt, torch.full((1,), 1000.0, device=cuda), plans)
    torch.cuda.synchronize()
    assert out.shape == (1, 1, 128, 128, cfg.vid_out_channels) and bool(out.float().isfinite().all())
    # under flash_attn_2 every layer prepares K5's operands in one K11 launch
    assert (k11.window_prepare.launches, k5.flash_attention.launches) == (cfg.num_layers, cfg.num_layers)
    k7 = quant.linear_apply
    assert (k7.launches, k7.launches_wgmma, k7.launches_splitk) == (288, 144, 144)
    D, hid = cfg.vid_dim, 4 * cfg.vid_dim
    shapes = {(M, K, N): cfg.num_layers for M in (4096, 58)
              for K, N in ((D, 3 * cfg.inner_dim), (cfg.inner_dim, D), (D, hid), (hid, D))}
    assert k7.launches_by_shape == shapes


@pytest.fixture
def memory_cap(cuda):
    """cap(gib) limits this process's share of the card
    (torch.cuda.set_per_process_memory_fraction); the cap is lifted at
    teardown, whatever the test did."""

    index = torch.cuda.current_device()  # the call takes a device index

    def cap(gib):
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(gib * 2**30 / torch.cuda.get_device_properties(index).total_memory,
                                                   index)

    yield cap
    torch.cuda.set_per_process_memory_fraction(1.0, index)
    torch.cuda.empty_cache()


def test_oom_ladder_reaches_a_tiled_rung_under_a_memory_cap(cuda, memory_cap, capsys):
    """A VAE decode of a 5 x 512x768 output under a cap halfway between the
    untiled decode's peak and the 512 px tiled decode's: the ladder fails
    untiled and at 1024 px (one tile: the untiled pass again), passes at
    512 px, and returns exactly the 512 px tiled decode (K1, K2 on each
    tile)."""
    import numpy as np

    from seedvr2_tpu_torch.config import PipelineConfig, VAEConfig
    from seedvr2_tpu_torch.models.params import init_random
    from seedvr2_tpu_torch.models.vae.model import VAE
    from seedvr2_tpu_torch.pipeline.runner import Runner

    vc = VAEConfig(block_out_channels=(128, 128, 256, 256), layers_per_block=1)
    cfg = PipelineConfig(vae=vc)
    vae = init_random(VAE(vc, cuda, torch.bfloat16), torch.Generator(device=cuda).manual_seed(12))
    runner = Runner(cfg, None, vae, np.zeros((1, cfg.dit.txt_in_dim), np.float32), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    lat = torch.randn((1, 2, 64, 96, vc.latent_channels), generator=g, device=cuda).bfloat16()

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated()

    _, untiled = peak(lambda: runner._decode(lat, False, (1024, 1024), (128, 128)))
    ref, tiled = peak(lambda: runner._decode(lat, True, (512, 512), (64, 64)))
    assert tiled < 0.8 * untiled, (tiled, untiled)
    n0 = (k1.conv3d_3x3x3.launches, k2.fold_upsample_conv.launches)
    memory_cap((tiled + untiled) / 2 / 2**30)
    out = runner.vae_decode(lat)
    torch.cuda.synchronize()
    log = capsys.readouterr().out
    assert "retrying with tiles (1024, 1024)" in log and "retrying with tiles (512, 512)" in log, log
    assert "host-staged" not in log
    assert k1.conv3d_3x3x3.launches > n0[0] and k2.fold_upsample_conv.launches > n0[1]
    assert torch.equal(out, ref)


def test_chunk_copies_through_the_copy_stream_equal_synchronous_copies(cuda):
    """The column chunks of a small bf16 batch (K1, K2 and K3 on the card)
    copied on the side stream into pinned buffers, each started as its
    chunk is yielded and its device tensor dropped at once while the card
    overwrites fresh allocations: the same codes as a synchronous .cpu() of
    the chunks."""
    import numpy as np

    from seedvr2_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig
    from seedvr2_tpu_torch.io.weights import random_dit, random_vae
    from seedvr2_tpu_torch.pipeline.phases import upload_frames
    from seedvr2_tpu_torch.pipeline.runner import Runner
    from seedvr2_tpu_torch.utils.transfer import HostCopies

    vc = VAEConfig(block_out_channels=(128, 128, 256, 256), layers_per_block=1)
    dc = DiTConfig(variant="small", vid_dim=256, txt_dim=256, emb_dim=6 * 256, heads=2, num_layers=2, mm_layers=1,
                   swiglu_multiple_of=64, sinusoidal_dim=64)
    cfg = PipelineConfig(dit=dc, vae=vc, resolution=128, decode_tiled=True, decode_tile_size=(128, 256),
                         decode_tile_overlap=(0, 64))
    g = torch.Generator(device=cuda).manual_seed(21)
    text = np.random.RandomState(22).randn(8, dc.txt_in_dim).astype(np.float32) * 0.1
    runner = Runner(cfg, random_dit(dc, g), random_vae(vc, g), text, device=cuda)
    frames = upload_frames(np.random.RandomState(23).randint(0, 256, (5, 64, 192, 3)).astype(np.uint8), cuda)
    plan = runner.supports_chunked(frames.shape, 128, 384)
    assert plan is not None and plan.emit == (128, 384)
    copies, refs, started = HostCopies(cuda), [], []
    for lo, hi, chunk in runner.fused_batch_chunks(frames, 128, 384, 42, plan):
        refs.append(chunk.cpu())
        started.append(copies.start(chunk))
        del chunk
        for _ in range(4):  # fresh allocations the allocator could hand the dropped chunk's memory to
            torch.full(refs[-1].shape, -7, dtype=torch.int32, device=cuda)
    assert len(started) == 2
    for ref, copy in zip(refs, started):
        host = copy.wait()
        assert host.is_pinned() and host.dtype == torch.int32 and host.shape == ref.shape
        assert torch.equal(host, ref)
