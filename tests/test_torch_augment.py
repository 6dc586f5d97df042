"""Noise augmentation, classifier-free guidance and the RGBA route of the
port vs the JAX package: phases.generate on vae_tiny + dit_tiny, fp32, the
same weights, text, frames and random draws (the JAX package's, handed to
the port through runner.Draws), on the fused path and on the 4-phase path;
pipeline/alpha.py alone; generate_multichip with RGBA frames and both noise
scales on two gloo ranks against JAX's on its 8-device CPU mesh.

Tolerances:
- generate atol=1e-4 on [0, 1] outputs (6.5 codes of 65535), as
  tests/test_torch_pipeline.py: both packages quantise to 16-bit codes on
  the fused routes and fp32 summation order moves a code now and then;
- the alpha upscale on the same inputs atol=1e-5 (the guided filter's box
  sums run in another order); end to end, the alpha of a gradient mask
  follows the RGB within the same 1e-4. A binary mask's alpha goes through
  8-bit truncations of the RGB (the Sobel edges), where a 1e-4 difference of
  the RGB can flip a code: there 99% of the alpha values are within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

import torch_rank_worker as ranks
from seedvr2_tpu.config import DiffusionConfig, PipelineConfig, dit_tiny, vae_tiny
from seedvr2_tpu.io.weights import flatten_tree
from seedvr2_tpu.models.dit.nadit import init_params as init_dit
from seedvr2_tpu.models.vae.model import init_vae_params
from seedvr2_tpu.ops.resize import side_resize_dims
from seedvr2_tpu.parallel.mesh import make_mesh as j_make_mesh
from seedvr2_tpu.pipeline import alpha as jalpha
from seedvr2_tpu.pipeline import batching as jbatching
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu.pipeline.multichip import generate_multichip as j_generate_multichip
from seedvr2_tpu.pipeline.runner import Runner as JRunner
from seedvr2_tpu.utils.seed import batch_key
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io.weights import dit_from_jax, vae_from_jax
from seedvr2_tpu_torch.pipeline import alpha, phases
from seedvr2_tpu_torch.pipeline.runner import Draws, Runner

ATOL = 1e-4


def _cfgs(**kw):
    vc, pvc = vae_tiny(), config.vae_tiny()
    dc = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    pdc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                              vid_out_channels=vc.latent_channels)
    pkw = dict(kw)
    if "diffusion" in kw:
        pkw["diffusion"] = config.DiffusionConfig(**dataclasses.asdict(kw["diffusion"]))
    base = dict(resolution=32, batch_size=5, compute_dtype="float32")
    jcfg, pcfg = PipelineConfig(dit=dc, vae=vc, **base, **kw), config.PipelineConfig(dit=pdc, vae=pvc, **base, **pkw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


jcfg0, _ = _cfgs()
DIT = _perturbed(init_dit(jcfg0.dit, jax.random.PRNGKey(0)), 1)
VAE = _perturbed(init_vae_params(jcfg0.vae, jax.random.PRNGKey(1)), 2)
TEXT = (np.random.RandomState(3).randn(4, jcfg0.dit.txt_in_dim) * 0.1).astype(np.float32)
TEXT_NEG = (np.random.RandomState(4).randn(6, jcfg0.dit.txt_in_dim) * 0.1).astype(np.float32)


def _frames(t, seed, channels=3, binary_alpha=True):
    rs = np.random.RandomState(seed)
    rgb = rs.rand(t, 24, 20, 3).astype(np.float32)
    if channels == 3:
        return rgb
    yy, xx = np.mgrid[0:24, 0:20]
    if binary_alpha:  # a disc: 0 / 1 with a sharp edge
        a = ((yy - 12) ** 2 + (xx - 10) ** 2 < 49).astype(np.float32)
    else:  # a ramp
        a = (xx / 19.0).astype(np.float32)
    return np.concatenate([rgb, np.broadcast_to(a[None, ..., None], (t, 24, 20, 1))], axis=-1)


def _padded_dims(cfg, frames):
    h, w = side_resize_dims(frames.shape[1], frames.shape[2], cfg.resolution, cfg.max_resolution)
    return -(-h // 16) * 16, -(-w // 16) * 16


def jax_draws(cfg, frames, specs=None):
    """The JAX package's draws of a run: the step's pair (split(batch_key(
    seed, 'dit'))) at a 5-frame batch's latent shape, and one input-noise
    draw a batch (split(batch_key(seed, 'input_noise')) in batch order) at
    the transformed batch's shape."""
    hp, wp = _padded_dims(cfg, frames)
    per = (2, hp // 8, wp // 8, cfg.vae.latent_channels)
    k1, k2 = jax.random.split(batch_key(cfg.seed, "dit"))
    dit = torch.from_numpy(np.array(jax.random.normal(k1, per, np.float32)))
    latent = torch.from_numpy(np.array(jax.random.normal(k2, per, np.float32)))
    if specs is None:
        overlap = jbatching.effective_overlap(cfg.batch_size, cfg.temporal_overlap)
        specs = jbatching.compute_batches(len(frames) + cfg.prepend_frames, cfg.batch_size, overlap,
                                          cfg.uniform_batch_size)
    key = batch_key(cfg.seed, "input_noise")
    inputs = []
    for spec in specs:
        key, sub = jax.random.split(key)
        t = jbatching.frames_to_4n1(spec.ori_length + spec.uniform_padding)
        assert t == 5  # one latent shape: one step draw serves every batch, as in the JAX package
        inputs.append(torch.from_numpy(np.array(jax.random.normal(sub, (t, hp, wp, 3), np.float32))))
    return Draws(dit=dit, latent=latent, inputs=inputs)


def _jax_generate(jcfg, frames, text_neg=None, **kw):
    runner = JRunner(jcfg, jax.tree.map(jnp.asarray, DIT), jax.tree.map(jnp.asarray, VAE), TEXT, text_neg)
    return jphases.generate(runner, frames, **kw)


def _port_runner(pcfg, text_neg=None):
    return Runner(pcfg, dit_from_jax(DIT, pcfg.dit, "cpu", torch.float32), vae_from_jax(VAE, pcfg.vae, "cpu", torch.float32),
                  TEXT, device="cpu", text_neg=text_neg)


# (settings, frames): every batch is 5 frames after 4n+1 padding (one step draw for all)
NOISE_CASES = {
    "input-fused": (dict(input_noise_scale=0.3), 9),
    "latent-fused": (dict(latent_noise_scale=0.2), 9),
    "both-fused-no-timestep-transform": (dict(input_noise_scale=0.3, latent_noise_scale=0.2,
                                              diffusion=DiffusionConfig(timestep_transform=False)), 5),
    "both-4phase-overlap": (dict(input_noise_scale=0.3, latent_noise_scale=0.2, temporal_overlap=2), 13),
    "both-4phase-packed": (dict(input_noise_scale=0.3, latent_noise_scale=0.2, fused_pipeline="off"), 9),
}


@pytest.mark.parametrize("case", list(NOISE_CASES))
def test_noise_augmentation_matches_jax(case):
    kw, t = NOISE_CASES[case]
    jcfg, pcfg = _cfgs(**kw)
    frames = _frames(t, t)
    packed = case.endswith("packed")
    ref = _jax_generate(jcfg, frames, packed=packed)
    got = phases.generate(_port_runner(pcfg), frames, packed=packed, noise=jax_draws(jcfg, frames))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = 65535.0 if packed else 1.0
    np.testing.assert_allclose(got.astype(np.float64) / scale, ref.astype(np.float64) / scale, atol=ATOL, rtol=0)
    # the augmentation moved the output (the draws reached the step)
    plain_cfg = _cfgs(**{k: v for k, v in kw.items() if not k.endswith("noise_scale")})[1]
    plain = phases.generate(_port_runner(plain_cfg), frames, packed=packed, noise=jax_draws(jcfg, frames).dit)
    assert np.abs(got.astype(np.float64) - plain.astype(np.float64)).max() / scale > 10 * ATOL


def test_input_noise_draws_follow_the_batch_order():
    """Without handed-in draws each batch takes the next draw of one
    generator seeded with seed + 2_000_000: two identical batches of one
    clip get different noise, and a second run repeats the first."""
    _, pcfg = _cfgs(input_noise_scale=0.5)
    frames = np.concatenate([_frames(5, 1)] * 2)
    runner = _port_runner(pcfg)
    noise = Draws(dit=jax_draws(_cfgs()[0], frames).dit)
    a = phases.generate(runner, frames, noise=noise)
    b = phases.generate(runner, frames, noise=noise)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a[:5] - a[5:]).max() > 1e-3


@pytest.mark.parametrize("route", [dict(), dict(temporal_overlap=2)])
def test_cfg_scale_matches_jax(route):
    """cfg_scale 2 with a 6-token negative prompt beside the 4-token one:
    the DiT runs on both (their own window plans), guided between them."""
    kw = dict(diffusion=DiffusionConfig(cfg_scale=2.0), **route)
    jcfg, pcfg = _cfgs(**kw)
    frames = _frames(9 if not route else 13, 21)
    ref = _jax_generate(jcfg, frames, TEXT_NEG)
    got = phases.generate(_port_runner(pcfg, TEXT_NEG), frames, noise=jax_draws(jcfg, frames).dit)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    plain = phases.generate(_port_runner(_cfgs(**route)[1]), frames, noise=jax_draws(jcfg, frames).dit)
    assert np.abs(got - plain).max() > 10 * ATOL


def test_cfg_scale_without_a_negative_embedding_raises():
    _, pcfg = _cfgs(diffusion=DiffusionConfig(cfg_scale=2.0))
    with pytest.raises(ValueError, match="negative text embedding"):
        phases.generate(_port_runner(pcfg), _frames(5, 0))


@pytest.mark.parametrize("binary", [False, True], ids=["gradient", "binary"])
@pytest.mark.parametrize("route", ["plain", "overlap-noise"])
def test_rgba_matches_jax(binary, route):
    """RGBA frames go the 4-phase way in both packages; the alpha skips the
    models and is upscaled against the upscaled RGB in phase 4."""
    kw = dict(temporal_overlap=2, input_noise_scale=0.3) if route != "plain" else {}
    jcfg, pcfg = _cfgs(**kw)
    frames = _frames(13 if kw else 9, 30, channels=4, binary_alpha=binary)
    ref = _jax_generate(jcfg, frames)
    got = phases.generate(_port_runner(pcfg), frames, noise=jax_draws(jcfg, frames))
    assert got.shape == ref.shape == (len(frames), 38, 32, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got[..., :3], ref[..., :3], atol=ATOL, rtol=0)
    diff = np.abs(got[..., 3] - ref[..., 3])
    if binary:
        assert (diff <= ATOL).mean() >= 0.99, float((diff > ATOL).mean())
    else:
        assert diff.max() <= ATOL, float(diff.max())
    assert 0.05 < ref[..., 3].mean() < 0.95


@pytest.mark.parametrize("binary", [False, True], ids=["gradient", "binary"])
def test_upscale_alpha_batch_matches_jax(binary):
    rs = np.random.RandomState(5)
    a = _frames(3, 5, channels=4, binary_alpha=binary)[..., 3:]
    rgb = np.clip(rs.rand(3, 38, 32, 3).astype(np.float32) * 0.2 + np.linspace(0, 0.8, 32, dtype=np.float32)[None, None, :, None],
                  0, 1)
    ref = jalpha.upscale_alpha_batch(a, rgb)
    got = alpha.upscale_alpha_batch(a, rgb, "cpu")
    assert got.shape == ref.shape == (3, 38, 32)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    edges_ref = np.asarray(jalpha.sobel_edges(jnp.asarray(rgb)))
    np.testing.assert_array_equal(alpha.sobel_edges(torch.from_numpy(rgb)).numpy(), edges_ref)


def test_generate_multichip_rgba_and_noise_matches_jax(tmp_path):
    """12 RGBA frames on data=2 (segments [0, 8) and [6, 12), a 2-frame seam
    blend), input and latent noise: the port's two gloo ranks against JAX's
    generate_multichip on make_mesh(data=2). The input draws are one a
    batch of the clip, the same for both segments."""
    kw = dict(input_noise_scale=0.3, latent_noise_scale=0.2)
    jcfg, _ = _cfgs(**kw)
    frames = _frames(12, 40, channels=4, binary_alpha=False)
    specs = jbatching.compute_batches(9, jcfg.batch_size, 0, uniform_batch_size=True)  # a 9-frame segment
    draws = jax_draws(jcfg, frames, specs)
    inputs = {"text": TEXT, "frames": frames, "dit_noise": draws.dit.numpy(), "latent_noise": draws.latent.numpy()}
    inputs.update({f"input_noise/{i}": z.numpy() for i, z in enumerate(draws.inputs)})
    inputs.update({f"dit/{k}": v for k, v in flatten_tree(DIT).items()})
    inputs.update({f"vae/{k}": v for k, v in flatten_tree(VAE).items()})
    np.savez(tmp_path / "inputs.npz", **inputs)
    case = dict(name="rgba_noise", kind="generate", frames="frames", noise="dit_noise", latent_noise="latent_noise",
                input_noise=[f"input_noise/{i}" for i in range(len(specs))], seam_overlap=2,
                pipeline=dict(resolution=32, batch_size=5, compute_dtype="float32", **kw))
    import json

    (tmp_path / "cases.json").write_text(json.dumps([case]))
    proc = ranks.start("multichip", tmp_path, 2)
    mesh = j_make_mesh(data=2)
    runner = JRunner(jcfg, jax.tree.map(jnp.asarray, DIT), jax.tree.map(jnp.asarray, VAE), TEXT, mesh=mesh)
    ref = j_generate_multichip(runner, frames, mesh, seam_overlap=2)
    got = ranks.finish(proc, tmp_path, 2)["rgba_noise"]
    assert got.shape == ref.shape == (12, 38, 32, 4)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
