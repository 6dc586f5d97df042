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

from seedvr2_tpu.models.vae import folded_upsample as jfold
from seedvr2_tpu.ops.conv3d_kernel import conv3d_3x3x3 as j_conv3d
from seedvr2_tpu.ops.fold_upsample_kernel import fold_upsample_conv as j_fold_conv
from seedvr2_tpu.ops.fused_window_attention import fused_window_attention as j_attn
from seedvr2_tpu_torch.models.vae import folded_upsample as tfold
from seedvr2_tpu_torch.ops import conv3d_kernel, fold_upsample_kernel, fused_window_attention

TOL = dict(atol=2e-4, rtol=1e-3)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 2, 16, 24, 128, 128), (2, 1, 5, 13, 128, 256)])
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


@pytest.mark.parametrize("rope_txt", [True, False])
def test_window_attention_plain_matches_pallas(rope_txt):
    B, H, nW, S, Lt, D = 1, 2, 3, 24, 5, 128
    vqkv, tqkv = _rand((B, 3, H, nW, S, D), 8), _rand((B, 3, H, Lt, D), 9)
    vang = np.random.RandomState(10).rand(nW, S, D).astype(np.float32) * 6
    tang = np.random.RandomState(11).rand(Lt, D).astype(np.float32) * 6 if rope_txt else np.zeros((Lt, D), np.float32)
    valid = np.ones((nW, S), bool)
    valid[1, 17:] = False  # ragged windows
    valid[2, 9:] = False
    norms = 1 + _rand((4, D), 12, 0.1)
    ref_v, ref_t = j_attn(
        jnp.asarray(vqkv), jnp.asarray(tqkv), jnp.asarray(vang), jnp.asarray(tang), jnp.asarray(valid),
        rope_txt, norms=jnp.asarray(norms), qk_norm=True, eps=1e-5, interpret=True,
    )
    t = torch.from_numpy
    got_v, got_t = fused_window_attention.fused_window_attention(
        t(vqkv), t(tqkv), t(vang).cos(), t(vang).sin(), t(tang).cos(), t(tang).sin(), t(valid), rope_txt, t(norms), True, 1e-5
    )
    mask = np.broadcast_to(valid[None, None, :, :, None], got_v.shape)
    np.testing.assert_allclose(got_v.numpy()[mask], np.asarray(ref_v)[mask], **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), **TOL)
