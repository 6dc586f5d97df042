"""K9, the VAE's GroupNorm (+ SiLU) apply pass on K8's tables
(csrc/gn_apply.cuh, ops/normalization.py:group_norm_frames), on the CPU.

- (a) the wrapper's CPU route (the plain version) against the JAX package's
  unfused GroupNorm + SiLU (models/vae/model.py:_gn then _silu, the
  function of causal_conv.py's unfused branch and of norm_out) and against
  _gn alone (the mid attention's), fp32, atol 1e-5 (fp32 statistics in
  another order);
- (b) the same in bf16: where a code differs, conv_ab.gn_codes's rule
  (one step, or within the fp32 rounding of the summands; a SiLU output
  one step where the normalised codes agree), the share stated;
- (c) K9's own arithmetic emulated in numpy (K8's tables from
  gn_silu_tables_plain, x * scale + shift as a rounded multiply and a
  rounded add, bf16, SiLU as x / (1 + exp(-x)) in fp32, bf16) against the
  JAX package's bf16 route under the same rule: the share of codes that
  K8 + K9 may move, which the card tests hold the kernels to;
- (d) a small VAE (32 / 64 channels, 8 groups: (C / groups) % 4 == 0, as
  K8 takes) encoding and decoding on the unfused route against the JAX
  package, every GroupNorm through group_norm_frames (counted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.config import VAEConfig
from seedvr2_tpu.models.vae import model as jmodel
from seedvr2_tpu_torch.conv_ab import gn_codes
from seedvr2_tpu_torch.io.weights import vae_from_jax
from seedvr2_tpu_torch.models.vae import causal_conv, model
from seedvr2_tpu_torch.models.vae.causal_conv import StreamCtx
from seedvr2_tpu_torch.ops import conv3d_kernel, normalization
from seedvr2_tpu_torch.ops.normalization import gn_apply, gn_apply_plain, group_norm_frames

F32 = np.float32
# (B, T, H, W, C, groups, mean offset): the VAE's widths at 32 groups, C = 128 at 4 groups, a frame of H * W
# not a multiple of anything, and means of 3 and 8 (x * scale + shift then cancels to the last bits)
CASES = [(1, 3, 12, 20, 128, 32, 0.0), (2, 2, 9, 17, 256, 32, 0.0), (1, 2, 6, 10, 512, 32, 0.0),
         (1, 2, 7, 11, 128, 4, 0.0), (1, 3, 12, 20, 128, 32, 8.0), (1, 2, 9, 16, 512, 32, 3.0)]
# the share of codes that may move: K8 + K9's arithmetic moves up to 2.9e-4 of the JAX package's in (c), the
# port's plain route up to 6.9e-4 in (b)
SHARE = 1e-3


def _inputs(B, T, H, W, C, seed, offset):
    rs = np.random.RandomState(seed)
    x = (offset + 1.5 * rs.randn(B, T, H, W, C)).astype(F32)
    gw, gb = (1 + 0.2 * rs.randn(C)).astype(F32), (0.3 * rs.randn(C)).astype(F32)
    return x, gw, gb


def _jax(x, gw, gb, groups, silu):
    """The JAX package's pass: per-frame _gn, then _silu (fp32 SiLU, rounded)."""
    y = jmodel._gn({"w": gw, "b": gb}, x, groups)
    return jmodel._silu(y) if silu else y


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, F32)).bfloat16()


def _from_jax(y) -> torch.Tensor:
    return _bf16(np.asarray(y.astype(jnp.float32)))


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_group_norm_frames_cpu_route_matches_jax_fp32(case, silu):
    B, T, H, W, C, groups, offset = case
    x, gw, gb = _inputs(B, T, H, W, C, 1, offset)
    ref = np.asarray(_jax(jnp.asarray(x), jnp.asarray(gw), jnp.asarray(gb), groups, silu))
    got = group_norm_frames(torch.from_numpy(x), torch.from_numpy(gw), torch.from_numpy(gb), groups, silu)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def _bf16_case(case, seed):
    """bf16 x and norm weights (the VAE's), as torch tensors and JAX arrays,
    with |x * scale| + |shift| of each value from K8's plain tables."""
    B, T, H, W, C, groups, offset = case
    x, gw, gb = (_bf16(a) for a in _inputs(B, T, H, W, C, seed, offset))
    xj, gwj, gbj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, gw, gb))
    scale, shift = conv3d_kernel.gn_silu_tables_plain(x, gw, gb, groups)
    mag = (x.float() * scale[:, :, None, None, :]).abs() + shift[:, :, None, None, :].abs()
    return (x, gw, gb), (xj, gwj, gbj), (scale, shift), mag


@pytest.mark.parametrize("case", CASES)
def test_group_norm_frames_cpu_route_matches_jax_bf16(case):
    """The plain route in bf16 against the JAX package's: at most 6.9e-4 of
    the codes differ here (mean 8), none beyond the rule of
    conv_ab.gn_codes."""
    groups = case[5]
    (x, gw, gb), (xj, gwj, gbj), _, mag = _bf16_case(case, 2)
    pre, out = (group_norm_frames(x, gw, gb, groups, silu) for silu in (False, True))
    ref_pre, ref_out = (_from_jax(_jax(xj, gwj, gbj, groups, silu)) for silu in (False, True))
    assert pre.dtype == out.dtype == torch.bfloat16
    codes = gn_codes(pre, ref_pre, mag, out, ref_out)
    assert codes["far"] == 0 and codes["share"] <= SHARE and codes["pre_share"] <= SHARE, codes


def _round_bf16(a: np.ndarray) -> np.ndarray:
    """fp32 -> the nearest bf16 (ties to even), as fp32."""
    u = a.astype(F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


def emulate_k9(x: np.ndarray, scale: np.ndarray, shift: np.ndarray, silu: bool) -> np.ndarray:
    """K9 on x [B, T, H, W, C] (fp32 holding bf16) and tables [B, T, C]: a
    rounded multiply, a rounded add (gn_apply.cuh: __fmul_rn, __fadd_rn),
    bf16; with ``silu``, v / (1 + exp(-v)) in fp32, bf16."""
    v = (x * scale[:, :, None, None, :]).astype(F32)
    v = _round_bf16((v + shift[:, :, None, None, :]).astype(F32))
    if silu:
        v = _round_bf16((v / (F32(1) + np.exp(-v))).astype(F32))
    return v


@pytest.mark.parametrize("case", CASES)
def test_k9_arithmetic_on_k8_tables_matches_jax_bf16(case):
    """K8's tables and K9's arithmetic against the JAX package's bf16 route:
    at most 2.9e-4 of the codes differ here (C = 128 at mean 8), none beyond
    the rule of conv_ab.gn_codes; the normalised values are gn_apply_plain's
    to the bit (the card tests hold K9 to that plain version)."""
    groups = case[5]
    (x, gw, gb), (xj, gwj, gbj), (scale, shift), mag = _bf16_case(case, 3)
    xs, sc, sf = x.float().numpy(), scale.numpy(), shift.numpy()
    pre, out = (_bf16(emulate_k9(xs, sc, sf, silu)) for silu in (False, True))
    ref_pre, ref_out = (_from_jax(_jax(xj, gwj, gbj, groups, silu)) for silu in (False, True))
    codes = gn_codes(pre, ref_pre, mag, out, ref_out)
    assert codes["far"] == 0 and codes["share"] <= SHARE and codes["pre_share"] <= SHARE, codes
    assert torch.equal(pre, gn_apply_plain(x, scale, shift, False))
    silu_codes = gn_codes(out, gn_apply_plain(x, scale, shift, True), mag)
    assert silu_codes["far"] == 0 and silu_codes["share"] <= 1e-3, silu_codes


@pytest.mark.parametrize("silu", [True, False])
def test_cpu_wrappers_run_the_plain_versions_and_count_nothing(silu):
    x, gw, gb = (torch.from_numpy(a) for a in _inputs(1, 2, 5, 6, 128, 4, 0.0))
    n0 = (gn_apply.launches, conv3d_kernel.gn_silu_tables.launches)
    want = normalization.group_norm_frames_plain(x, gw, gb, 32, silu)
    assert torch.equal(group_norm_frames(x, gw, gb, 32, silu), want)
    scale, shift = conv3d_kernel.gn_silu_tables_plain(x, gw, gb, 32)
    assert torch.equal(gn_apply(x, scale, shift, silu), gn_apply_plain(x, scale, shift, silu))
    assert (gn_apply.launches, conv3d_kernel.gn_silu_tables.launches) == n0


def test_a_tensor_off_the_cpu_never_takes_the_plain_version():
    """Only a CPU tensor runs the plain version: any other device goes to the
    kernels' checks, which refuse a tensor that is not on a CUDA card."""
    x = torch.empty(1, 2, 4, 4, 128, dtype=torch.bfloat16, device="meta")
    gw = torch.empty(128, device="meta")
    tables = torch.empty(1, 2, 128, device="meta")
    with pytest.raises(ValueError):
        gn_apply(x, tables, tables, True)
    with pytest.raises(ValueError):
        group_norm_frames(x, gw, gw, 32, True)


def test_k9_geometry_fills_whole_blocks():
    for C in (8, 64, 128, 256, 384, 512, 2048, 8192):
        ppb, steps = normalization.gn_apply_geometry(C)
        assert 1 <= ppb * (C // 8) <= 1024 and steps % 4 == 0
    for C in (128, 256, 512):
        ppb, steps = normalization.gn_apply_geometry(C)
        assert ppb * (C // 8) == 256 and ppb * steps * C * 2 == 64 * 1024


VAE_SMALL = VAEConfig(latent_channels=4, block_out_channels=(32, 32, 64, 64), layers_per_block=1, norm_num_groups=8)


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, F32) + rs.randn(*np.shape(l)).astype(F32) * 0.05 for l in leaves]
    )


def gn_calls_per_pass(cfg) -> dict:
    """GroupNorms in one encoder and one decoder call: two a resnet (the
    down blocks' layers_per_block, the up blocks' one more, the mid block's
    two), norm_out and, with mid attention, its GroupNorm."""
    mid = 2 * 2 + int(cfg.mid_block_attention)
    return {"encoder": 2 * cfg.layers_per_block * cfg.num_blocks + mid + 1,
            "decoder": 2 * (cfg.layers_per_block + 1) * cfg.num_blocks + mid + 1}


def test_small_vae_unfused_route_matches_jax(monkeypatch):
    """Encoder and decoder (GN fusion off, the default) against the JAX
    package's, tolerance of tests/test_torch_vae.py (atol = rtol = 5e-4);
    every GroupNorm of the pass goes through group_norm_frames (the resnets'
    and norm_out's with the SiLU, the mid attention's without), one call
    each."""
    cfg = VAE_SMALL
    params = _perturbed(jmodel.init_vae_params(cfg, jax.random.PRNGKey(5)), 6)
    vae = vae_from_jax(params, cfg, "cpu", torch.float32)
    assert not vae.gn_fusion
    calls = []

    def counted(x, gw, gb, groups, silu, eps=1e-6):
        calls.append(silu)
        return group_norm_frames(x, gw, gb, groups, silu, eps)

    monkeypatch.setattr(causal_conv, "group_norm_frames", counted)
    monkeypatch.setattr(model, "group_norm_frames", counted)
    x = np.tanh(np.random.RandomState(7).randn(1, 5, 16, 16, 3)).astype(F32)
    jp = jax.tree.map(jnp.asarray, params)
    ref_m = np.asarray(jmodel.encoder_forward(jp, cfg, jnp.asarray(x)))
    z = np.ascontiguousarray(ref_m[..., : cfg.latent_channels])
    ref = np.asarray(jmodel.decoder_forward(jp, cfg, jnp.asarray(z)))
    want = gn_calls_per_pass(cfg)
    got_m = vae.encoder(torch.from_numpy(x), StreamCtx("disabled"))
    assert len(calls) == want["encoder"] and calls.count(False) == int(cfg.mid_block_attention)
    np.testing.assert_allclose(got_m.numpy(), ref_m, atol=5e-4, rtol=5e-4)
    got = vae.decoder(torch.from_numpy(z), StreamCtx("disabled"))
    assert len(calls) == want["encoder"] + want["decoder"]
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=5e-4)


def test_released_vae_blocks_run_52_group_norms_a_pass(monkeypatch):
    """The count chip_smoke.py expects of K8 and K9 on the unfused route for
    one encode and one decode of the released VAE (5 frames, no temporal
    slice): its blocks (VAEConfig()'s, at 1/16 of the width) run 48 resnet
    GroupNorms (20 + 28: K1's count on the card) + norm_out and the mid
    attention's in each half."""
    from seedvr2_tpu_torch.config import VAEConfig as TorchVAEConfig
    from seedvr2_tpu_torch.models.params import init_random
    from seedvr2_tpu_torch.models.vae.model import VAE

    cfg = TorchVAEConfig(block_out_channels=(8, 16, 32, 32), norm_num_groups=4)
    assert gn_calls_per_pass(cfg) == {"encoder": 22, "decoder": 30}
    vae = init_random(VAE(cfg, "cpu", torch.float32), torch.Generator().manual_seed(0))
    calls = []

    def counted(x, gw, gb, groups, silu, eps=1e-6):
        calls.append((silu, x.shape[-1]))
        return group_norm_frames(x, gw, gb, groups, silu, eps)

    monkeypatch.setattr(causal_conv, "group_norm_frames", counted)
    monkeypatch.setattr(model, "group_norm_frames", counted)
    moments = vae.encoder(torch.rand(1, 5, 16, 16, 3), StreamCtx("disabled"))
    assert moments.shape == (1, 2, 2, 2, 32) and len(calls) == 22
    vae.decoder(moments[..., :16].contiguous(), StreamCtx("disabled"))
    assert len(calls) == 52 and calls.count((False, 32)) == 2
