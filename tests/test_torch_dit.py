"""The port's NaDiT vs the JAX package's forward (Pallas in interpret
mode), same weights via dit_from_jax, same inputs, fp32: the 3B-style
(mmrope3d, SwiGLU, shared and video-only layers) and the 7B-style
(window_pixel, GELU, no text RoPE) tiny configs under every attention
backend (fused = K3, fused_int8 = K3q, pallas = K5, xla = plain).

Tolerance atol=2e-4, rtol=1e-3, as tests/test_fused_attention.py holds the
JAX fused path against its unfused one. The port is given its own config
objects with the JAX ones' field values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.config import dit_tiny
from seedvr2_tpu.io.weights import dit_key_map
from seedvr2_tpu_torch import config
from seedvr2_tpu.models.dit import nadit as jnadit
from seedvr2_tpu.ops.attention import get_attention_backend, set_attention_backend
from seedvr2_tpu_torch.io.weights import dit_from_jax
from seedvr2_tpu_torch.models.dit import nadit
from seedvr2_tpu_torch.models.params import leaf_paths

TOL = dict(atol=2e-4, rtol=1e-3)


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


@pytest.mark.parametrize("thw,txt_len,B", [((2, 6, 8), 4, 1), ((1, 4, 6), 3, 2)])
def test_nadit_forward_matches_jax(thw, txt_len, B):
    """dit_tiny: one separate-weight layer, then a shared-weight, video-only
    last layer; the vid_out_ada quirk; mmrope3d with text rope."""
    cfg = dit_tiny()
    params = _perturbed(jnadit.init_params(cfg, jax.random.PRNGKey(0)), 1)
    rs = np.random.RandomState(2)
    vid = (rs.randn(B, thw[0], thw[1] * 2, thw[2] * 2, cfg.vid_in_channels) * 0.4).astype(np.float32)
    txt = (rs.randn(B, txt_len, cfg.txt_in_dim) * 0.4).astype(np.float32)
    t = np.full((B,), 800.0, np.float32)
    plans = jnadit.build_attn_plans(cfg, thw, txt_len)
    prev = get_attention_backend()
    set_attention_backend("fused")
    try:
        ref = np.asarray(
            jnadit.nadit_forward(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(t), plans)
        )
    finally:
        set_attention_backend(prev)
    pcfg = config.dit_tiny()
    model = dit_from_jax(params, pcfg, "cpu", torch.float32)
    dplans = nadit.device_plans(nadit.build_attn_plans(pcfg, thw, txt_len), pcfg.head_dim, "cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t), dplans).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("backend", ["fused", "fused_int8", "pallas", "xla"])
@pytest.mark.parametrize("rope_type", ["mmrope3d", "window_pixel", None, "none"])
def test_nadit_forward_every_backend_matches_jax(rope_type, backend):
    """B = 2, a latent whose windows are ragged in both plans, 3 text tokens.
    rope_type None / "none": no RoPE, which the JAX package runs under every
    backend (zero angles in the fused kernels, no rotation on the unfused
    path)."""
    cfg = dit_tiny(rope_type)
    thw, txt_len, B = (2, 6, 8), 3, 2
    params = _perturbed(jnadit.init_params(cfg, jax.random.PRNGKey(3)), 4)
    rs = np.random.RandomState(5)
    vid = (rs.randn(B, thw[0], thw[1] * 2, thw[2] * 2, cfg.vid_in_channels) * 0.4).astype(np.float32)
    txt = (rs.randn(B, txt_len, cfg.txt_in_dim) * 0.4).astype(np.float32)
    t = np.full((B,), 700.0, np.float32)
    plans = jnadit.build_attn_plans(cfg, thw, txt_len)
    prev = get_attention_backend()
    set_attention_backend(backend)
    try:
        ref = np.asarray(
            jnadit.nadit_forward(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(t), plans)
        )
    finally:
        set_attention_backend(prev)
    pcfg = config.dit_tiny(rope_type)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    model = dit_from_jax(params, pcfg, "cpu", torch.float32).set_attention_mode(backend)
    assert model.attention_backend == backend
    dplans = nadit.device_plans(nadit.build_attn_plans(pcfg, thw, txt_len), pcfg.head_dim, "cpu")
    assert dplans[0].rope_txt == (rope_type == "mmrope3d")
    with torch.inference_mode():
        got = model(torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t), dplans).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("shifted", [False, True])
def test_attn_plans_match_jax(shifted):
    thw, txt_len = (3, 10, 14), 5
    ours = nadit.build_attn_plans(config.dit_tiny(), thw, txt_len)
    ref = jnadit.build_attn_plans(dit_tiny(), thw, txt_len)
    a, b = (ours.shifted, ref.shifted) if shifted else (ours.plain, ref.plain)
    np.testing.assert_array_equal(a.plan.index, b.plan.index)
    np.testing.assert_array_equal(a.vid_angles, b.vid_angles)
    np.testing.assert_array_equal(a.txt_angles, b.txt_angles)


@pytest.mark.parametrize("shifted", [False, True])
def test_window_pixel_attn_plans_match_jax(shifted):
    """7B-style plans: pixel RoPE on video, no text angles."""
    thw, txt_len = (3, 10, 14), 5
    ours = nadit.build_attn_plans(config.dit_tiny("window_pixel"), thw, txt_len)
    ref = jnadit.build_attn_plans(dit_tiny("window_pixel"), thw, txt_len)
    a, b = (ours.shifted, ref.shifted) if shifted else (ours.plain, ref.plain)
    np.testing.assert_array_equal(a.plan.index, b.plan.index)
    np.testing.assert_array_equal(a.vid_angles, b.vid_angles)
    assert a.txt_angles is None and b.txt_angles is None


def test_dit_leaf_paths_match_the_jax_key_map():
    ours = {p for p, _, _ in leaf_paths(nadit.NaDiT(config.dit_tiny(), "meta", torch.float32))}
    assert ours == set(dit_key_map(dit_tiny()))


@pytest.mark.parametrize("factory,args", [("dit_tiny", ("window_pixel",)), ("dit_7b", ())])
def test_dit_leaf_paths_match_the_jax_key_map_7b(factory, args):
    from seedvr2_tpu import config as jconfig

    ours = {p for p, _, _ in leaf_paths(nadit.NaDiT(getattr(config, factory)(*args), "meta", torch.float32))}
    assert ours == set(dit_key_map(getattr(jconfig, factory)(*args)))


def test_7b_rope_covers_60_of_128_dims():
    """window_pixel at 7B (rope_dim 64): 3 axes x 20 rotated dims; the rest of the head
    dim is zero-padded (cos 1, sin 0): an identity. Text is not roped."""
    cfg = config.dit_7b()
    dp = nadit.device_plans(nadit.build_attn_plans(cfg, (2, 45, 80), 58), cfg.head_dim, "cpu")
    for p in dp:
        assert not p.rope_txt
        assert torch.all(p.vid_cos[..., 60:] == 1) and torch.all(p.vid_sin[..., 60:] == 0)
        assert torch.all(p.txt_cos == 1) and torch.all(p.txt_sin == 0)
    assert tuple(dp[0].valid.shape) == (18, 405) and tuple(dp[1].valid.shape) == (32, 405)


def test_unknown_attention_mode_raises():
    with pytest.raises(ValueError, match="Unknown attention backend"):
        nadit.NaDiT(config.dit_tiny(), "meta", torch.float32, attention_mode="flash")


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("rope_type", ["mmrope3d", "window_pixel", None])
def test_pallas_operands_match_the_jax_unfused_path(rope_type, shifted, qk_norm, monkeypatch):
    """The "pallas" route's preparation on the CPU (K11's plain version,
    ops/window_prepare.py) against the JAX package's unfused window
    attention: the q, k, v and key mask that each route hands its attention
    call, captured there, for layer 0 (separate video and text weights), B =
    2, windows ragged in both plans, with and without the qk norm; text
    roped only under mmrope3d. Same fp32 weights and inputs on both sides."""
    cfg = dataclasses.replace(dit_tiny(rope_type), qk_norm=qk_norm)
    pcfg = dataclasses.replace(config.dit_tiny(rope_type), qk_norm=qk_norm)
    params = _perturbed(jnadit.init_params(cfg, jax.random.PRNGKey(6)), 7)
    thw, txt_len, B = (2, 6, 8), 3, 2
    rs = np.random.RandomState(8)
    vid = (rs.randn(B, int(np.prod(thw)), cfg.vid_dim) * 0.5).astype(np.float32)
    txt = (rs.randn(B, txt_len, cfg.vid_dim) * 0.5).astype(np.float32)
    seen = {}

    def capture(side):
        def attention(q, k, v, kv_valid=None, **_):
            seen[side] = [np.asarray(x) for x in (q, k, v, kv_valid)]
            return q

        return attention

    plans = jnadit.build_attn_plans(cfg, thw, txt_len)
    monkeypatch.setattr(jnadit, "attention", capture("jax"))
    jnadit._window_attention(jax.tree.map(jnp.asarray, params)["blocks"][0]["attn"], cfg, jnp.asarray(vid),
                             jnp.asarray(txt), plans.shifted if shifted else plans.plain, True)
    model = dit_from_jax(params, pcfg, "cpu", torch.float32).set_attention_mode("flash_attn_2")
    dp = nadit.device_plans(nadit.build_attn_plans(pcfg, thw, txt_len), pcfg.head_dim, "cpu")[int(shifted)]
    monkeypatch.setattr(nadit, "attention", capture("torch"))
    with torch.inference_mode():
        model._window_attention_unfused(model.blocks[0].attn, torch.from_numpy(vid), torch.from_numpy(txt), dp)
    *ops, mask = seen["torch"]
    *ref, ref_mask = seen["jax"]
    np.testing.assert_array_equal(mask, ref_mask)
    for got, want in zip(ops, ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
