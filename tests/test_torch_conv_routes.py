"""The VAE's convolutions against the contracts of the kernels they are
routed to (csrc/conv_pipeline.cuh: K1 / K4 take Cin % 64 and Cout % 128, K2
takes kt in 1..3, A in 1..2 and C % 64), for the 3B and 7B pipelines' VAE,
built on the meta device (no weights); and K2's schedule (a tile is one
phase (a, u, v) of a low-res patch, its slab starting at low-res pixel
(u - 1, v - 1), tap (dh, dw) at shift (dh, dw) and folded-weight rows
(dt * 4 + dh * 2 + dw) * C, the bias bc + the expansion-bias table of the
taps inside the frame: csrc/fold_upsample.cuh's FoldPolicy) applied in
plain torch against the JAX package's XLA form of fold_upsample_conv
(_phase_conv + _interleave, the bias riding a ones channel) on the CPU, in
fp32 at a tiny C. Tolerance: atol=2e-5, rtol=1e-5 (fp32 sums in different
orders over at most 3 * 4 * 8 products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.models.vae import folded_upsample as jfold
from seedvr2_tpu.ops import conv3d_kernel as jck
from seedvr2_tpu_torch.config import pipeline_3b, pipeline_7b
from seedvr2_tpu_torch.models.vae import folded_upsample as tfold
from seedvr2_tpu_torch.models.vae.causal_conv import CausalConv3d
from seedvr2_tpu_torch.models.vae.model import VAE

PIPELINES = {"3b": pipeline_3b, "7b": pipeline_7b}


def _meta_vae(variant):
    return VAE(PIPELINES[variant]().vae, device="meta")


@pytest.mark.parametrize("variant", list(PIPELINES))
def test_every_k1_routed_conv_meets_the_kernel_contract(variant):
    """The convs the routing rule sends to K1 (and, with GroupNorm fusion,
    to K4) are the JAX package's, and each has Cin % 64 == 0 and Cout % 128
    == 0 (the pipeline's stage depth and tile width)."""
    routed = []
    for name, m in _meta_vae(variant).named_modules():
        if isinstance(m, CausalConv3d):
            shape = m.spec["w"][0]
            assert m.k1 == (m.spatial_pad == ((1, 1), (1, 1)) and jck.enabled_for(shape, m.stride)), name
            if m.k1:
                routed.append(shape)
    assert len(routed) == 48  # 20 in the encoder, 28 in the decoder (chip_smoke.py's K1 count a batch)
    for kt, kh, kw, cin, cout in routed:
        assert (kt, kh, kw) == (3, 3, 3) and cin % 64 == 0 and cout % 128 == 0


@pytest.mark.parametrize("variant", list(PIPELINES))
def test_every_folded_upsample_meets_the_k2_contract(variant):
    """Every fold of each decoder upsample (the causal head's s0 / s12, the
    streaming pair, the spatial-only tz1) is a K2 launch with kt in 1..3,
    A in 1..2 and C % 64 == 0."""
    seen = set()
    for m in _meta_vae(variant).modules():
        if isinstance(m, tfold.FoldedUpsample):
            C = m.conv.spec["w"][0][-1]
            for tmap, kt, A in (tfold._FOLDS_TZ2 if m.temporal_up else tfold._FOLDS_TZ1).values():
                assert kt in (1, 2, 3) and A in (1, 2) and C % 64 == 0 and len(tmap) == A
                seen.add((kt, A, C))
    assert {(kt, A) for kt, A, _ in seen} == {(1, 1), (2, 2), (3, 1)}


def _k2_schedule(x, K, btab, bc, A):
    """fold_upsample_conv as K2's tiles compute it, one phase at a time."""
    B, F, H, W, C = x.shape
    kt = K.shape[0]
    Tp, P = F - kt + 1, A * 4 * C
    Kf, bt = K.reshape(kt * 4 * C, P), btab.reshape(4, P)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # TMA's zero fill around the frame
    i, j = torch.arange(H)[:, None], torch.arange(W)[None, :]
    y = torch.empty(B, Tp * A, 2 * H, 2 * W, C)
    for a in range(A):
        for u in (0, 1):
            for v in (0, 1):
                pcol = ((a * 2 + u) * 2 + v) * C
                acc = torch.zeros(B, Tp, H, W, C)
                bias = bc + bt[:, pcol:pcol + C].sum(0)
                for tap in range(4):
                    dh, dw = tap >> 1, tap & 1  # the slab (origin (u - 1, v - 1)) at shift (dh, dw)
                    for dt in range(kt):
                        rows = Kf[(dt * 4 + tap) * C:(dt * 4 + tap + 1) * C, pcol:pcol + C]
                        acc += xp[:, dt:dt + Tp, u + dh:u + dh + H, v + dw:v + dw + W] @ rows
                    outside = (i + u + dh - 1 < 0) | (i + u + dh - 1 >= H) | (j + v + dw - 1 < 0) | (j + v + dw - 1 >= W)
                    acc -= outside[..., None] * bt[tap, pcol:pcol + C]
                y[:, a::A, u::2, v::2] = acc + bias
    return y


@pytest.mark.parametrize("kt,A", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2)])
def test_k2_schedule_equals_the_jax_reference(kt, A):
    C, H, W, Tp = 4, 5, 7, 2
    rs = np.random.RandomState(kt * 10 + A)
    x = rs.randn(2, Tp + kt - 1, H, W, C).astype(np.float32)
    K = (rs.randn(kt, 2, 2, C, A * 4 * C) * 0.3).astype(np.float32)
    btab = (rs.randn(2, 2, A * 4 * C) * 0.5).astype(np.float32)
    bc = (rs.randn(C) * 0.3).astype(np.float32)
    aug = np.zeros((kt, 2, 2, C + 1, A * 4 * C), np.float32)
    aug[:, :, :, :C], aug[0, :, :, C] = K, btab
    ref = np.asarray(jfold._interleave(jfold._phase_conv(jfold._augment(jnp.asarray(x)), jnp.asarray(aug)), A, C))
    ref = ref + bc
    got = _k2_schedule(*map(torch.from_numpy, (x, K, btab, bc)), A)
    assert got.shape == ref.shape == (2, Tp * A, 2 * H, 2 * W, C)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)
