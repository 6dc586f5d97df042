"""K4 (the GroupNorm + SiLU conv prologue) and K6 (the tap-folded conv): the
port's tables and plain versions against the JAX package's Pallas kernels in
interpret mode, and the 128-channel VAE with GroupNorm fusion on against the
JAX package's with set_gn_fusion(True), on the same numpy inputs in fp32.

Tolerances: the tables within 1e-6 (the same two-pass fp32 statistics);
the convs atol=3e-4, rtol=1e-3, as the JAX package's own fused-GN test
(tests/test_conv3d_kernel.py), im2col atol=2e-4, rtol=1e-3, as its im2col
test: fp32 products summed in different orders; the VAE atol=5e-4,
rtol=5e-4, as tests/test_torch_vae.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.config import VAEConfig
from seedvr2_tpu.models.vae import causal_conv as jcausal
from seedvr2_tpu.models.vae import model as jmodel
from seedvr2_tpu.models.vae import tiling as jtiling
from seedvr2_tpu.ops import conv3d_kernel as jck
from seedvr2_tpu_torch.io.weights import vae_from_jax
from seedvr2_tpu_torch.models.vae import tiling
from seedvr2_tpu_torch.models.vae.causal_conv import CausalConv3d, StreamCtx
from seedvr2_tpu_torch.ops import conv3d_kernel

GN_TOL = dict(atol=3e-4, rtol=1e-3)
IM2COL_TOL = dict(atol=2e-4, rtol=1e-3)
VAE_TOL = dict(atol=5e-4, rtol=5e-4)
# Two 128-channel blocks (2x down/up in space and time): every resnet conv is
# K1-routed, and the model is shallow enough that JAX's interpret-mode
# kernels compile in ~30 s for the encode's two slice modes and one decode.
VAE_128 = VAEConfig(latent_channels=4, block_out_channels=(128, 128), layers_per_block=1, norm_num_groups=32,
                    temporal_scale_num=1, temporal_downsample_factor=2, spatial_downsample_factor=2)


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def _gn_inputs(shape, seed):
    B, T, H, W, cin, cout = shape
    x = _rand((B, T + 2, H, W, cin), seed, 0.7, 0.3)
    w, b = _rand((3, 3, 3, cin, cout), seed + 1, 0.05), _rand((cout,), seed + 2, 0.1)
    gw, gb = 1.0 + _rand((cin,), seed + 3, 0.2), _rand((cin,), seed + 4, 0.2)
    return x, w, b, gw, gb


# The shapes of the JAX package's fused-GN test, then the CUDA kernel's
# edges: H, W not multiples of its 16 x 16 patch (9 x 17, W < 16), Cin !=
# Cout, B = 2 at T = 1.
GN_SHAPES = [(1, 3, 16, 256, 128, 128), (2, 2, 10, 130, 256, 128), (1, 1, 9, 17, 128, 128), (2, 1, 5, 7, 256, 128),
             (1, 1, 6, 10, 512, 256), (1, 2, 9, 17, 128, 256)]


@pytest.mark.parametrize("groups", [32, 4])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_silu_tables_match_jax(shape, groups):
    x, _, _, gw, gb = _gn_inputs(shape, 0)
    ref = jck.gn_silu_tables(jnp.asarray(x), jnp.asarray(gw), jnp.asarray(gb), groups)
    got = conv3d_kernel.gn_silu_tables(torch.from_numpy(x), torch.from_numpy(gw), torch.from_numpy(gb), groups)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_k4_plain_matches_pallas_with_the_halo_zeroed_after_normalisation(shape):
    """GN_SHAPES. silu(shift) is far from
    0 at these tables, so a version that normalised the zero padding as well
    (the trap the kernel's predicated loads avoid) would miss by far more
    than the tolerance: that version is computed and required to disagree."""
    x, w, b, gw, gb = _gn_inputs(shape, 10)
    sc, sf = jck.gn_silu_tables(jnp.asarray(x), jnp.asarray(gw), jnp.asarray(gb), 32)
    ref = np.asarray(jck.conv3d_3x3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True, scale=sc, shift=sf))
    t = torch.from_numpy
    scale, shift = conv3d_kernel.gn_silu_tables(t(x), t(gw), t(gb), 32)
    n0 = (conv3d_kernel.conv3d_3x3x3.launches, conv3d_kernel.conv3d_3x3x3.launches_gn)
    got = conv3d_kernel.conv3d_3x3x3(t(x), t(w), t(b), scale, shift)
    assert (conv3d_kernel.conv3d_3x3x3.launches, conv3d_kernel.conv3d_3x3x3.launches_gn) == n0  # CPU: plain version
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **GN_TOL)

    silu_shift = torch.nn.functional.silu(shift)
    assert float(silu_shift.abs().mean()) > 0.05
    padded = torch.nn.functional.pad(t(x), (0, 0, 1, 1, 1, 1))  # raw zeros around the image
    wrong = conv3d_kernel.conv3d_3x3x3_plain(conv3d_kernel.gn_silu_apply(padded, scale, shift), t(w), t(b))
    wrong = wrong[:, :, 1:-1, 1:-1]
    assert np.abs(wrong.numpy() - ref).max() > 100 * GN_TOL["atol"]


def test_k4_wrapper_needs_both_tables():
    x = torch.zeros(1, 3, 4, 4, 128)
    with pytest.raises(ValueError):
        conv3d_kernel.conv3d_3x3x3(x, torch.zeros(3, 3, 3, 128, 128), torch.zeros(128), scale=torch.zeros(1, 3, 128))


# The shapes of the JAX package's im2col test, then the CUDA kernel's tiling
# edges (tests/test_torch_kernels_gpu.py IM2COL_CASES): H, W not multiples
# of its patch and W below its width, B = 2 at T = 1 and T = 3, Cin != Cout,
# Cout 128 / 256 / 512, Cin 64 and 512, more tiles than the card has SMs.
IM2COL_SHAPES = [(1, 2, 16, 256, 128, 128), (1, 1, 6, 130, 256, 128), (2, 1, 9, 13, 64, 128), (2, 3, 20, 7, 128, 256),
                 (1, 2, 17, 33, 512, 128), (1, 1, 10, 70, 256, 512), (2, 1, 8, 64, 128, 128), (1, 1, 4, 130, 128, 128),
                 (1, 3, 160, 160, 128, 256), (2, 2, 36, 40, 512, 256), (1, 1, 24, 24, 64, 512)]


@pytest.mark.parametrize("shape", IM2COL_SHAPES)
def test_k6_plain_matches_pallas_im2col(shape):
    """IM2COL_SHAPES (B, T, H, W, Cin, Cout)."""
    B, T, H, W, cin, cout = shape
    x, w, b = _rand((B, T + 2, H, W, cin), 20, 0.5), _rand((3, 3, 3, cin, cout), 21, 0.05), _rand((cout,), 22, 0.1)
    ref = np.asarray(jck.conv3d_3x3x3_im2col(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    n0 = conv3d_kernel.conv3d_3x3x3.launches
    got = conv3d_kernel.conv3d_3x3x3_im2col(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert conv3d_kernel.conv3d_3x3x3.launches == n0  # a CPU tensor runs the plain version: no K1 launch
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **IM2COL_TOL)


class _JaxGnFusion:
    """The JAX package's module-global GN fusion and conv backend, set for a
    block and restored after it (xdist runs a whole file in one worker)."""

    def __init__(self, fusion: bool):
        self.fusion = fusion

    def __enter__(self):
        self.prev = (jcausal._GN_FUSION, jck._ENABLED)
        jcausal.set_gn_fusion(self.fusion)
        jck.set_conv_backend("pallas")

    def __exit__(self, *exc):
        jcausal.set_gn_fusion(self.prev[0])
        jck.set_conv_backend("pallas" if self.prev[1] else "xla")


def test_resnet_conv_gn_fusion_streaming_matches_jax():
    """One K1-routed conv with gn= under fusion, one shot and as init +
    active slices (the carry stays raw), against the JAX package's."""
    cin, cout, groups = 128, 128, 32
    x, w, b, gw, gb = _rand((1, 7, 6, 9, cin), 30), _rand((3, 3, 3, cin, cout), 31, 0.05), _rand((cout,), 32, 0.1), \
        1.0 + _rand((cin,), 33, 0.2), _rand((cin,), 34, 0.3)
    conv = CausalConv3d((3, 3, 3), cin, cout, "cpu", torch.float32)
    conv.set_jax("w", w)
    conv.set_jax("b", b)
    conv.gn_fusion = True
    norm = type("Norm", (), {"w": torch.from_numpy(gw), "b": torch.from_numpy(gb)})()
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    jgn = ({"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, groups)
    with _JaxGnFusion(True):
        ref = np.asarray(jcausal.causal_conv3d(jp, jnp.asarray(x), jcausal.StreamCtx("disabled"), "c", gn=jgn))
        jctx = jcausal.StreamCtx("init")
        jo1 = jcausal.causal_conv3d(jp, jnp.asarray(x[:, :3]), jctx, "c", gn=jgn)
        jo2 = jcausal.causal_conv3d(jp, jnp.asarray(x[:, 3:]), jcausal.StreamCtx("active", jctx.out_state), "c", gn=jgn)
    xt = torch.from_numpy(x)
    full = conv(xt, StreamCtx("disabled"), "c", gn=(norm, groups))
    ctx1 = StreamCtx("init")
    o1 = conv(xt[:, :3], ctx1, "c", gn=(norm, groups))
    assert torch.equal(ctx1.out_state["c/mem"], xt[:, 1:3])  # the raw tail, not the normalised one
    o2 = conv(xt[:, 3:], StreamCtx("active", ctx1.out_state), "c", gn=(norm, groups))
    np.testing.assert_allclose(full.numpy(), ref, **GN_TOL)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), np.asarray(jnp.concatenate([jo1, jo2], 1)), **GN_TOL)


@pytest.fixture(scope="module")
def vae_128():
    params = _perturbed(jmodel.init_vae_params(VAE_128, jax.random.PRNGKey(5)), 6)
    return params, vae_from_jax(params, VAE_128, "cpu", torch.float32)


def test_128_channel_vae_with_gn_fusion_matches_jax(vae_128):
    """Every resnet conv of the encoder and decoder runs K4's plain version;
    JAX runs _kernel_gn in interpret mode. 9 frames run the sliced encode
    (5 + 4 frames): init + active streaming. The decode takes the first 3
    latent frames in one slice: each slice mode is a JAX compile of every
    interpret-mode kernel, and the resnet conv test above holds the fused
    conv's streaming."""
    params, vae = vae_128
    vae.set_gn_fusion(True)
    try:
        x = np.tanh(_rand((1, 9, 8, 8, 3), 40))
        jp = jax.tree.map(jnp.asarray, params)
        with _JaxGnFusion(True):
            ref_lat = np.asarray(jtiling.vae_encode(jp, VAE_128, jnp.asarray(x)))
            ref = np.asarray(jtiling.vae_decode(jp, VAE_128, jnp.asarray(ref_lat[:, :3])))
        n0 = conv3d_kernel.conv3d_3x3x3.launches_gn
        lat = tiling.vae_encode(vae, torch.from_numpy(x))
        np.testing.assert_allclose(lat.numpy(), ref_lat, **VAE_TOL)
        got = tiling.vae_decode(vae, torch.from_numpy(ref_lat[:, :3].copy()))
        np.testing.assert_allclose(got.numpy(), ref, **VAE_TOL)
        assert conv3d_kernel.conv3d_3x3x3.launches_gn == n0  # CPU tensors: the plain version
    finally:
        vae.set_gn_fusion(False)


def test_gn_fusion_is_a_model_setting(vae_128):
    _, vae = vae_128
    convs = [m for m in vae.modules() if isinstance(m, CausalConv3d)]
    assert not vae.gn_fusion and not any(c.gn_fusion for c in convs)
    assert vae.set_gn_fusion(True) is vae and all(c.gn_fusion for c in convs)
    vae.set_gn_fusion(False)
    assert not any(c.gn_fusion for c in convs)
