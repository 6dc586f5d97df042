"""The plain versions of K1, K2, K3 (what the port runs on a CPU tensor, and
what the CUDA kernels are checked against on the card) vs the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs in fp32.

Tolerance atol=2e-4, rtol=1e-3, as the JAX package's own kernel tests
(tests/test_conv3d_kernel.py, tests/test_fused_attention.py): both sides
accumulate fp32 products in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.models.vae import folded_upsample as jfold
from seedvr2_tpu.ops.conv3d_kernel import conv3d_3x3x3 as j_conv3d
from seedvr2_tpu.ops.fold_upsample_kernel import fold_upsample_conv as j_fold_conv
from seedvr2_tpu.ops.fused_window_attention import fused_window_attention as j_attn
from seedvr2_tpu.ops.normalization import rms_norm as j_rms_norm
from seedvr2_tpu.ops.rope import apply_rotary as j_apply_rotary
from seedvr2_tpu_torch.models.vae import folded_upsample as tfold
from seedvr2_tpu_torch.ops import conv3d_kernel, fold_upsample_kernel, fused_window_attention

TOL = dict(atol=2e-4, rtol=1e-3)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# The CUDA kernel's edges (tests/test_torch_kernels_gpu.py): H, W not
# multiples of its 16 x 16 patch (9 x 17, W < 16), Cin != Cout, B = 2 at T = 1.
CONV_SHAPES = [(1, 2, 16, 24, 128, 128), (2, 1, 5, 13, 128, 256), (1, 1, 9, 17, 128, 128), (2, 1, 5, 7, 256, 128),
               (1, 1, 6, 10, 512, 256), (1, 2, 9, 17, 128, 256)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3d_plain_matches_pallas(shape):
    """Includes an H, W that is not a multiple of the kernel's tiles."""
    B, T, H, W, cin, cout = shape
    x, w, b = _rand((B, T + 2, H, W, cin), 0, 0.5), _rand((3, 3, 3, cin, cout), 1, 0.05), _rand((cout,), 2, 0.1)
    ref = np.asarray(j_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = conv3d_kernel.conv3d_3x3x3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert conv3d_kernel.conv3d_3x3x3.launches == 0  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_conv3d_routing_rule():
    assert conv3d_kernel.enabled_for((3, 3, 3, 128, 256), (1, 1, 1))
    assert not conv3d_kernel.enabled_for((1, 3, 3, 128, 128), (1, 1, 1))
    assert not conv3d_kernel.enabled_for((3, 3, 3, 128, 128), (2, 2, 2))
    assert not conv3d_kernel.enabled_for((3, 3, 3, 3, 128), (1, 1, 1))


_TMAPS = {(1, 1): ("_T_MAP_S0", 2), (2, 2): ("_T_MAP_PAIR", 2), (3, 1): ("_T_MAP_TZ1", 1)}


@pytest.mark.parametrize("kt,A", [(1, 1), (2, 2), (3, 1)])
def test_fold_upsample_plain_matches_pallas(kt, A):
    """K/btab from both packages' _fold_core; the port's plain conv vs the
    Pallas kernel in interpret mode, incl. the masked expansion bias."""
    tmap_name, tz = _TMAPS[(kt, A)]
    c = 128
    W, E, be = _rand((3, 3, 3, c, c), 3, 0.2), _rand((c, c * 4 * tz), 4, 0.3), _rand((c * 4 * tz,), 5, 0.5)
    K_j, bt_j = jfold._fold_core(jnp.asarray(W), jnp.asarray(E), jnp.asarray(be), tz, getattr(jfold, tmap_name), kt)
    K_t, bt_t = tfold.fold_core(torch.from_numpy(W), torch.from_numpy(E), torch.from_numpy(be), tz, getattr(tfold, tmap_name), kt)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bt_t.numpy(), np.asarray(bt_j), atol=1e-4, rtol=1e-4)
    x = _rand((1, kt + 1, 9, 6, c), 6)
    bc = _rand((c,), 7, 0.3)
    ref = np.asarray(j_fold_conv(jnp.asarray(x), K_j, bt_j, jnp.asarray(bc), A, interpret=True))
    got = fold_upsample_kernel.fold_upsample_conv(torch.from_numpy(x), K_t, bt_t, torch.from_numpy(bc), A)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("C", [128, 256, 512])
@pytest.mark.parametrize("kt,A", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2)])
def test_fold_upsample_plain_matches_pallas_at_the_kernel_edges(kt, A, C):
    """Every (kt, A) the kernel takes, at odd H, W (a ragged 16 x 16 patch)
    and the decoder's widths; random folded weights and bias table."""
    x = _rand((1, kt, 5, 7, C), 40)
    K = _rand((kt, 2, 2, C, A * 4 * C), 41, (kt * 4 * C) ** -0.5)
    btab, bc = _rand((2, 2, A * 4 * C), 42, 0.5), _rand((C,), 43, 0.3)
    ref = np.asarray(j_fold_conv(jnp.asarray(x), jnp.asarray(K), jnp.asarray(btab), jnp.asarray(bc), A, interpret=True))
    got = fold_upsample_kernel.fold_upsample_conv(torch.from_numpy(x), *map(torch.from_numpy, (K, btab, bc)), A)
    assert got.shape == ref.shape == (1, A, 10, 14, C)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# The corners the CUDA kernel is held to on the card (tests/test_torch_kernels_gpu.py),
# so that the plain version it is compared with there is held to the Pallas kernel
# here: a window whose video slots are all invalid, B = 2, no qk norm, R = S + Lt
# an exact multiple of 128 and one row over, all-zero q/k rows, and the corners of
# the flash loop's 64-row tiles: S a multiple of 64 (the video/text switch on a
# tile edge), S = 1, Lt = 1 and Lt > 64 (two text tiles).
WINDOW_CASES = {
    "True": dict(rope_txt=True),
    "False": dict(rope_txt=False),
    "all_invalid": dict(invalid_window=0),
    "B2": dict(B=2),
    "no_qk_norm": dict(qk_norm=False),
    "R128": dict(S=120, Lt=8, nW=1),
    "R129": dict(S=121, Lt=8, nW=1),
    "zero_rows": dict(zero_rows=True),
    "S64": dict(S=64, Lt=8),
    "S1": dict(S=1, Lt=5),
    "Lt1": dict(Lt=1),
    "Lt65": dict(S=24, Lt=65),
}


def window_inputs(seed, rope_txt=True, B=1, nW=3, S=24, Lt=5, qk_norm=True, invalid_window=None, zero_rows=False):
    """numpy inputs of fused_window_attention, windows 1 and 2 ragged."""
    H, D = 2, 128
    vqkv, tqkv = _rand((B, 3, H, nW, S, D), seed), _rand((B, 3, H, Lt, D), seed + 1)
    if zero_rows:  # q and k of video slot 5 of window 0 and of text token 1
        vqkv[:, :2, :, 0, 5] = 0.0
        tqkv[:, :2, :, 1] = 0.0
    vang = np.random.RandomState(seed + 2).rand(nW, S, D).astype(np.float32) * 6
    tang = np.random.RandomState(seed + 3).rand(Lt, D).astype(np.float32) * 6 if rope_txt else np.zeros((Lt, D), np.float32)
    valid = np.ones((nW, S), bool)
    valid[1:2, S * 17 // 24 :] = False  # ragged windows
    valid[2:3, S * 9 // 24 :] = False
    if invalid_window is not None:
        valid[invalid_window] = False
    norms = 1 + _rand((4, D), seed + 4, 0.1)
    return vqkv, tqkv, vang, tang, valid, rope_txt, norms, qk_norm


def window_pallas_vs_plain(inputs, quant_qk):
    """(plain, Pallas interpret) outputs on the same inputs, the padded video
    query slots included (both compute them; downstream drops them)."""
    vqkv, tqkv, vang, tang, valid, rope_txt, norms, qk_norm = inputs
    ref_v, ref_t = j_attn(
        jnp.asarray(vqkv), jnp.asarray(tqkv), jnp.asarray(vang), jnp.asarray(tang), jnp.asarray(valid),
        rope_txt, norms=jnp.asarray(norms), qk_norm=qk_norm, eps=1e-5, interpret=True, quant_qk=quant_qk,
    )
    t = torch.from_numpy
    got_v, got_t = fused_window_attention.fused_window_attention(
        t(vqkv), t(tqkv), t(vang).cos(), t(vang).sin(), t(tang).cos(), t(tang).sin(), t(valid), rope_txt, t(norms),
        qk_norm, 1e-5, quant_qk,
    )
    return (got_v.numpy(), got_t.numpy()), (np.asarray(ref_v), np.asarray(ref_t))


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_attention_plain_matches_pallas(case):
    (got_v, got_t), (ref_v, ref_t) = window_pallas_vs_plain(window_inputs(8, **WINDOW_CASES[case]), quant_qk=False)
    np.testing.assert_allclose(got_v, ref_v, **TOL)
    np.testing.assert_allclose(got_t, ref_t, **TOL)


@pytest.mark.parametrize("case", ["True", "False", "no_qk_norm", "Lt65"])
def test_window_qk_prepare_plain_matches_jax(case):
    """The first step of the split plain version (what the preparation kernel
    is held to on the card): q and k normalised and roped as the JAX
    package's rms_norm and apply_rotary do them, which is what its Pallas
    kernel computes before the products."""
    vqkv, tqkv, vang, tang, valid, rope_txt, norms, qk_norm = window_inputs(8, **WINDOW_CASES[case])
    t = torch.from_numpy
    got = fused_window_attention.qk_prepare_plain(t(vqkv), t(tqkv), t(vang).cos(), t(vang).sin(), t(tang).cos(),
                                                  t(tang).sin(), rope_txt, t(norms), qk_norm, 1e-5)

    def jax_prepare(x, row, angles, rope):
        y = j_rms_norm(jnp.asarray(x), jnp.asarray(norms[row]), 1e-5) if qk_norm else jnp.asarray(x)
        return np.asarray(j_apply_rotary(y, jnp.asarray(angles)) if rope else y)

    ref = (jax_prepare(vqkv[:, 0], 0, vang, True), jax_prepare(vqkv[:, 1], 1, vang, True),
           jax_prepare(tqkv[:, 0], 2, tang, rope_txt), jax_prepare(tqkv[:, 1], 3, tang, rope_txt))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, **TOL)


@pytest.mark.parametrize("quant_qk", [False, True])
@pytest.mark.parametrize("case", ["True", "S1", "Lt65"])
def test_window_attention_prepared_plain_matches_pallas(case, quant_qk):
    """The second step on its own (what the flash loop is held to): the
    Pallas kernel in interpret mode with its norm and RoPE switched off
    (qk_norm False, zero angles: an exact identity) on the prepared q/k rows
    equals window_attention_prepared_plain on the same rows."""
    vqkv, tqkv, vang, tang, valid, rope_txt, norms, qk_norm = window_inputs(9, **WINDOW_CASES[case])
    t = torch.from_numpy
    vq, vk, tq, tk = fused_window_attention.qk_prepare_plain(
        t(vqkv), t(tqkv), t(vang).cos(), t(vang).sin(), t(tang).cos(), t(tang).sin(), rope_txt, t(norms), qk_norm, 1e-5)
    pv = np.stack([vq.numpy(), vk.numpy(), vqkv[:, 2]], axis=1)
    pt = np.stack([tq.numpy(), tk.numpy(), tqkv[:, 2]], axis=1)
    ref_v, ref_t = j_attn(jnp.asarray(pv), jnp.asarray(pt), jnp.zeros(vang.shape), jnp.zeros(tang.shape),
                          jnp.asarray(valid), False, norms=jnp.ones(norms.shape), qk_norm=False, eps=1e-5,
                          interpret=True, quant_qk=quant_qk)
    got_v, got_t = fused_window_attention.window_attention_prepared_plain(
        vq, vk, t(vqkv[:, 2]), tq, tk, t(tqkv[:, 2]), t(valid), quant_qk)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), **TOL)
