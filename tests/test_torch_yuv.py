"""yuv420 of the port vs the JAX package (seedvr2_tpu/ops/yuv.py): the
conversions in both directions at 8 and 10 bits, on the device (torch) and
on the host (numpy); the fused path's sink planes and the planar input
routes of phases.generate on vae_tiny + dit_tiny, fp32, the same weights,
text, frames and DiT noise (JAX's draw, handed to the port).

Tolerances: the numpy forms are the same arithmetic and must agree
exactly; the torch conversions to codes round fp32 values that the two
libraries may sum in another order, so a code may differ by 1 (at most
0.1% of them); the conversions to RGB atol=1e-6; the pipeline's planes
within 1 code of JAX's (its RGB output is within 1e-4 of [0, 1], 6.5 codes
of 65535, and a 10-bit code is 64 of those), so the RGB that the host
converts from them moves by at most one code of each plane (3.1e-3) and
99% of it stays within 1e-4; other RGB outputs atol=1e-4, as
tests/test_torch_pipeline.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.config import PipelineConfig, dit_tiny, vae_tiny
from seedvr2_tpu.models.dit.nadit import init_params as init_dit
from seedvr2_tpu.models.vae.model import init_vae_params
from seedvr2_tpu.ops import yuv as jyuv
from seedvr2_tpu.ops.resize import side_resize_dims
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu.pipeline.runner import Runner as JRunner
from seedvr2_tpu.utils.seed import batch_key
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io.weights import dit_from_jax, vae_from_jax
from seedvr2_tpu_torch.ops import yuv
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.pipeline.runner import Runner

ATOL = 1e-4
# RGB moved by one 10-bit code in each plane: Y 1/876 plus Cb's 1.772/896
PLANE_CODE_RGB = 1 / 876 + 1.772 / 896


def _rgb(seed, t=3, h=8, w=12):
    return np.random.RandomState(seed).rand(t, h, w, 3).astype(np.float32)


def _planes(p):
    return [np.asarray(x) for x in (p.y, p.u, p.v)]


@pytest.mark.parametrize("depth", [8, 10])
def test_numpy_forms_equal_jax(depth):
    rgb = _rgb(depth)
    got, ref = yuv.rgb01_to_yuv420_np(rgb, depth), jyuv.rgb01_to_yuv420_np(rgb, depth)
    assert got.depth == ref.depth == depth and got.shape == ref.shape == (3, 8, 12, 3)
    for a, b in zip(_planes(got), _planes(ref)):
        assert a.dtype == b.dtype == (np.uint8 if depth == 8 else np.uint16)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(yuv.yuv420_to_rgb01_np(got), jyuv.yuv420_to_rgb01_np(ref))


@pytest.mark.parametrize("depth", [8, 10])
def test_device_conversions_match_jax(depth):
    rgb = _rgb(depth + 1, t=4, h=16, w=24)
    ref = jyuv.rgb01_to_yuv420(jnp.asarray(rgb), depth)
    got = yuv.rgb01_to_yuv420(torch.from_numpy(rgb), depth)
    assert got.y.dtype == (torch.uint8 if depth == 8 else torch.int16)
    for a, b in zip(_planes(got.to_numpy()), _planes(ref)):
        assert a.dtype == b.dtype
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (int(d.max()), float((d > 0).mean()))
    # codes -> RGB: the same codes on both sides
    planes = jyuv.rgb01_to_yuv420_np(rgb, depth)
    back_ref = np.asarray(jyuv.yuv420_to_rgb01(jax.tree.map(jnp.asarray, planes)))
    back = yuv.yuv420_to_rgb01(yuv.PlanarYUV420(*_planes(planes), depth).to_device("cpu")).numpy()
    np.testing.assert_allclose(back, back_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(back, yuv.yuv420_to_rgb01_np(planes), atol=1e-6, rtol=0)


def test_planar_container_slices_and_bytes_like_jax():
    p = yuv.rgb01_to_yuv420_np(_rgb(3, t=5), 10)
    j = jyuv.PlanarYUV420(*_planes(p), 10)
    for key in (slice(1, 4), 2, -1):
        np.testing.assert_array_equal(p[key].y, j[key].y)
        assert len(p[key]) == len(j[key])
    assert p.tobytes() == j.tobytes()
    assert p.shape == j.shape == (5, 8, 12, 3) and p.ndim == 4
    with pytest.raises(TypeError):
        p[[0, 1]]


# --------------------------------------------------------------------------- #
# The pipeline
# --------------------------------------------------------------------------- #


def _cfgs(**kw):
    vc = vae_tiny()
    dc = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    pdc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                              vid_out_channels=vc.latent_channels)
    base = dict(resolution=32, batch_size=5, compute_dtype="float32", **kw)
    jcfg, pcfg = PipelineConfig(dit=dc, vae=vc, **base), config.PipelineConfig(dit=pdc, vae=config.vae_tiny(), **base)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


J0, _ = _cfgs()
DIT = _perturbed(init_dit(J0.dit, jax.random.PRNGKey(0)), 1)
VAE = _perturbed(init_vae_params(J0.vae, jax.random.PRNGKey(1)), 2)
TEXT = (np.random.RandomState(3).randn(4, J0.dit.txt_in_dim) * 0.1).astype(np.float32)


def _jax_noise(cfg, h, w):
    th, tw = side_resize_dims(h, w, cfg.resolution, cfg.max_resolution)
    k1, _ = jax.random.split(batch_key(cfg.seed, "dit"))
    per = (2, -(-th // 16) * 2, -(-tw // 16) * 2, cfg.vae.latent_channels)
    return torch.from_numpy(np.array(jax.random.normal(k1, per, np.float32)))


def _runs(kw, frames, packed):
    jcfg, pcfg = _cfgs(**kw)
    ref = jphases.generate(JRunner(jcfg, jax.tree.map(jnp.asarray, DIT), jax.tree.map(jnp.asarray, VAE), TEXT), frames,
                           packed=packed)
    runner = Runner(pcfg, dit_from_jax(DIT, pcfg.dit, "cpu", torch.float32),
                    vae_from_jax(VAE, pcfg.vae, "cpu", torch.float32), TEXT, device="cpu")
    port_frames = yuv.PlanarYUV420(*_planes(frames), frames.depth) if jyuv.is_planar(frames) else frames
    got = phases.generate(runner, port_frames, packed=packed, noise=_jax_noise(jcfg, frames.shape[1], frames.shape[2]))
    return ref, got


@pytest.mark.parametrize("bits", [8, 16])
def test_fused_path_packs_the_sinks_planes_like_jax(bits):
    """output_pixfmt yuv420 on the fused path: the planes of the clip (9
    frames, two batches) at 8 or 10 bits; the planes agree with
    rgb01_to_yuv420_np of the port's own RGB output within 1 code."""
    frames = _rgb(11, t=9, h=24, w=20)
    ref, got = _runs(dict(output_pixfmt="yuv420", output_bits=bits), frames, packed=True)
    assert yuv.is_planar(got) and jyuv.is_planar(ref)
    assert got.depth == ref.depth == (8 if bits == 8 else 10) and got.shape == ref.shape == (9, 38, 32, 3)
    for a, b in zip(_planes(got), _planes(ref)):
        assert a.dtype == b.dtype
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
    _, rgb = _runs(dict(output_bits=bits), frames, packed=False)
    for a, b in zip(_planes(got), _planes(yuv.rgb01_to_yuv420_np(rgb, got.depth))):
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1


def test_fused_path_unpacked_yuv_sink_returns_rgb_like_jax():
    """A caller that does not take packed output gets RGB floats: the
    planes converted on the host, batch by batch."""
    frames = _rgb(12, t=5, h=24, w=20)
    ref, got = _runs(dict(output_pixfmt="yuv420"), frames, packed=False)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    diff = np.abs(got - ref)
    assert (diff <= ATOL).mean() >= 0.99 and diff.max() <= PLANE_CODE_RGB, (float((diff > ATOL).mean()), float(diff.max()))


@pytest.mark.parametrize("route", ["fused", "4-phase-overlap", "4-phase-off"])
@pytest.mark.parametrize("depth", [8, 10])
def test_planar_input_matches_jax(route, depth):
    """Planar frames: raw planes to the device on the fused path, converted
    once up front on the 4-phase routes."""
    kw = {"fused": {}, "4-phase-overlap": dict(temporal_overlap=2), "4-phase-off": dict(fused_pipeline="off")}[route]
    frames = jyuv.rgb01_to_yuv420_np(_rgb(13 + depth, t=9 if route != "4-phase-overlap" else 13, h=24, w=20), depth)
    ref, got = _runs(kw, frames, packed=False)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
