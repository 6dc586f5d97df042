"""The port's causal VAE vs the JAX package's, same weights, same inputs, fp32.

Weights come from the JAX init with every leaf perturbed (biases, norms and
expansions non-trivial), loaded through seedvr2_tpu_torch.io.weights.
Tolerance atol=5e-4, rtol=5e-4 (the JAX package's folded-upsample tests use
the same): the fold reassociates fp32 sums and deep conv stacks accumulate
order differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvr2_tpu.config import VAEConfig, vae_tiny
from seedvr2_tpu.models.vae import folded_upsample as jfold
from seedvr2_tpu.models.vae import model as jmodel
from seedvr2_tpu.models.vae import tiling as jtiling
from seedvr2_tpu.models.vae.causal_conv import StreamCtx as JStreamCtx
from seedvr2_tpu.models.vae.causal_conv import causal_conv3d as j_causal_conv3d
from seedvr2_tpu_torch.io.weights import vae_from_jax
from seedvr2_tpu_torch.models.vae import tiling
from seedvr2_tpu_torch.models.vae.causal_conv import CausalConv3d, StreamCtx
from seedvr2_tpu_torch.models.vae.folded_upsample import FoldedUpsample
from seedvr2_tpu_torch.models.vae.model import VAE

TOL = dict(atol=5e-4, rtol=5e-4)
VAE_128 = VAEConfig(latent_channels=4, block_out_channels=(128, 128, 128, 128), layers_per_block=1, norm_num_groups=32)


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    cfg = vae_tiny()
    params = _perturbed(jmodel.init_vae_params(cfg, jax.random.PRNGKey(0)), 1)
    return cfg, params, vae_from_jax(params, cfg, "cpu", torch.float32)


@pytest.mark.parametrize("cin,cout", [(8, 16), (128, 128)])
def test_causal_conv_streaming_matches_single_pass_and_jax(cin, cout):
    conv = CausalConv3d((3, 3, 3), cin, cout, "cpu", torch.float32)
    w, b = _rand((3, 3, 3, cin, cout), 2, 0.05), _rand((cout,), 3, 0.1)
    conv.set_jax("w", w)
    conv.set_jax("b", b)
    x = _rand((1, 7, 6, 5, cin), 4)
    xt = torch.from_numpy(x)
    full = conv(xt, StreamCtx("disabled"), "c")
    ctx1 = StreamCtx("init")
    o1 = conv(xt[:, :3], ctx1, "c")
    o2 = conv(xt[:, 3:], StreamCtx("active", ctx1.out_state), "c")
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), full.numpy(), atol=1e-5, rtol=1e-5)
    ref = j_causal_conv3d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), JStreamCtx("disabled"), "c")
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("temporal_up", [True, False])
def test_upsample_folded_init_and_active_match_jax(temporal_up):
    c, ratio = 8, 8 if temporal_up else 4
    p = {
        "upscale": {"w": _rand((1, 1, 1, c, c * ratio), 5, 0.3), "b": _rand((c * ratio,), 6, 0.5)},
        "conv": {"w": _rand((3, 3, 3, c, c), 7, 0.2), "b": _rand((c,), 8, 0.5)},
    }
    up = FoldedUpsample(c, temporal_up, "cpu", torch.float32)
    for mod in ("upscale", "conv"):
        for leaf in ("w", "b"):
            getattr(up, mod).set_jax(leaf, p[mod][leaf])
    up.prepare()
    jp = jax.tree.map(jnp.asarray, p)
    slices = [_rand((1, t, 6, 5, c), 10 + i) for i, t in enumerate([3, 2, 2])]
    outs, jouts, state, jstate = [], [], {}, {}
    for i, xs in enumerate(slices):
        mode = "init" if i == 0 else "active"
        ctx, jctx = StreamCtx(mode, state), JStreamCtx(mode, jstate)
        outs.append(up(torch.from_numpy(xs), ctx, "upsample"))
        jouts.append(jfold.upsample_folded(jp, vae_tiny(), jnp.asarray(xs), jctx, "upsample", temporal_up))
        state, jstate = ctx.out_state, jctx.out_state
    got, ref = torch.cat(outs, 1).numpy(), np.asarray(jnp.concatenate(jouts, 1))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("T", [5, 9])
def test_tiny_encode_decode_match_jax(tiny, T):
    """T=9 runs the sliced (streaming) encode and decode."""
    cfg, params, vae = tiny
    x = np.tanh(_rand((1, T, 16, 24, 3), 20))
    jp = jax.tree.map(jnp.asarray, params)
    ref_lat = np.asarray(jtiling.vae_encode(jp, cfg, jnp.asarray(x)))
    lat = tiling.vae_encode(vae, torch.from_numpy(x))
    np.testing.assert_allclose(lat.numpy(), ref_lat, **TOL)
    ref = np.asarray(jtiling.vae_decode(jp, cfg, jnp.asarray(ref_lat)))
    np.testing.assert_allclose(tiling.vae_decode(vae, torch.from_numpy(ref_lat.copy())).numpy(), ref, **TOL)


def test_128_channel_vae_matches_jax():
    """Every resnet conv routes to K1 (plain version here), the upsamples to
    K2. JAX runs its plain reference, the XLA conv lowering (interpret-mode
    Pallas is held against it in tests/test_conv3d_kernel.py and against
    the port's K1 plain version in tests/test_torch_kernels.py)."""
    from seedvr2_tpu.ops import conv3d_kernel as jck

    cfg = VAE_128
    params = _perturbed(jmodel.init_vae_params(cfg, jax.random.PRNGKey(3)), 4)
    vae = vae_from_jax(params, cfg, "cpu", torch.float32)
    assert vae.encoder.down0.resnets[0].conv1.k1 and not vae.encoder.conv_in.k1
    x = np.tanh(_rand((1, 5, 16, 16, 3), 21))
    jp = jax.tree.map(jnp.asarray, params)
    enabled = jck._ENABLED
    jck.set_conv_backend("xla")
    try:
        ref_m = np.asarray(jmodel.encoder_forward(jp, cfg, jnp.asarray(x)))
        ref = np.asarray(jmodel.decoder_forward(jp, cfg, jnp.asarray(ref_m[..., : cfg.latent_channels])))
    finally:
        jck.set_conv_backend("pallas" if enabled else "xla")
    got_m = vae.encoder(torch.from_numpy(x), StreamCtx("disabled"))
    np.testing.assert_allclose(got_m.numpy(), ref_m, **TOL)
    z = np.ascontiguousarray(ref_m[..., : cfg.latent_channels])
    got = vae.decoder(torch.from_numpy(z), StreamCtx("disabled"))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_vae_leaf_paths_match_the_jax_key_map():
    """Every leaf of the port's VAE is a key of the JAX package's checkpoint
    map, and the other way round."""
    from seedvr2_tpu.io.weights import vae_key_map
    from seedvr2_tpu_torch.models.params import leaf_paths

    cfg = vae_tiny()
    ours = {p for p, _, _ in leaf_paths(VAE(cfg, "meta", torch.float32))}
    assert ours == set(vae_key_map(cfg))
