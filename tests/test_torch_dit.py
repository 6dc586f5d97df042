"""The port's NaDiT vs the JAX package's fused-attention forward (Pallas in
interpret mode), same weights via dit_from_jax, same inputs, fp32.

Tolerance atol=2e-4, rtol=1e-3, as tests/test_fused_attention.py holds the
JAX fused path against its unfused one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvr2_tpu.config import dit_tiny
from seedvr2_tpu.io.weights import dit_key_map
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
    model = dit_from_jax(params, cfg, "cpu", torch.float32)
    dplans = nadit.device_plans(nadit.build_attn_plans(cfg, thw, txt_len), cfg.head_dim, "cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t), dplans).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("shifted", [False, True])
def test_attn_plans_match_jax(shifted):
    cfg = dit_tiny()
    thw, txt_len = (3, 10, 14), 5
    ours = nadit.build_attn_plans(cfg, thw, txt_len)
    ref = jnadit.build_attn_plans(cfg, thw, txt_len)
    a, b = (ours.shifted, ref.shifted) if shifted else (ours.plain, ref.plain)
    np.testing.assert_array_equal(a.plan.index, b.plan.index)
    np.testing.assert_array_equal(a.vid_angles, b.vid_angles)
    np.testing.assert_array_equal(a.txt_angles, b.txt_angles)


def test_dit_leaf_paths_match_the_jax_key_map():
    cfg = dit_tiny()
    ours = {p for p, _, _ in leaf_paths(nadit.NaDiT(cfg, "meta", torch.float32))}
    assert ours == set(dit_key_map(cfg))
