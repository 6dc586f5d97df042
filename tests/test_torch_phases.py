"""The long-clip path of the port vs the JAX package: the colour methods
(seedvr2_tpu/ops/color.py), the overlap blend (ops/blending.py), the run
budget (pipeline/phases.py:_run_budget) and phases.generate through the
4-phase pipeline on tiny configs (vae_tiny + dit_tiny, fp32, the same
weights, text and DiT noise: JAX's draw, handed to the port).

Tolerances:
- colour methods atol=2e-5 (measured <= 2e-7; hsv exact): the histogram
  matches use stable sorts on both sides, so equal values keep one order;
  lab atol=5e-4: its a*/b* channels run to +-100, where the two libms'
  fp32 pow and cbrt differ by a few ulps (6e-5 measured in rgb_to_lab),
  and the a*/b* histogram match can then swap two values that close, each
  taking its neighbour's reference quantile (1.6e-4 measured, three seeds);
- generate atol=1e-4 on [0, 1] outputs (6.5 codes of 65535), as
  tests/test_torch_pipeline.py: both packages quantise to 16-bit codes on
  the fused routes, and fp32 summation order moves a value across a
  rounding boundary now and then. The histogram methods (lab, hsv,
  wavelet_adaptive) rank every pixel: where the fp32 noise of the decode
  (~1e-6) reorders two values that close, each takes its neighbour's
  reference quantile. There the bound is 99.5% of the values within 1e-4
  and all within 2e-3 (measured: 0.27% and 1.3e-3 at worst); on identical
  inputs the methods agree within the colour tolerances above.
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
from seedvr2_tpu.ops import blending as jblending
from seedvr2_tpu.ops import color as jcolor
from seedvr2_tpu.ops.resize import side_resize_dims
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu.pipeline.runner import Runner as JRunner
from seedvr2_tpu.utils.seed import batch_key
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io.weights import dit_from_jax, vae_from_jax
from seedvr2_tpu_torch.ops import blending, color
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.pipeline.runner import Runner

COLOR_ATOL = 2e-5
LAB_ATOL = 5e-4
ATOL = 1e-4

# --------------------------------------------------------------------------- #
# Colour methods and blending
# --------------------------------------------------------------------------- #


def _images(seed, shape=(2, 3, 48, 40)):
    """Continuous values inside (-1, 1): no clipping ties in the hue and
    saturation histograms; 3840 pixels put every hue bin above hsv's
    100-pixel floor."""
    return (np.random.RandomState(seed).rand(*shape).astype(np.float32) * 1.8 - 0.9)


@pytest.mark.parametrize("method", ["wavelet", "lab", "hsv", "wavelet_adaptive", "adain", "none"])
def test_color_method_matches_jax(method):
    content, style = _images(0), _images(1) * 0.7 + 0.1
    ref = np.asarray(jcolor.apply_color_correction(method, jnp.asarray(content), jnp.asarray(style)))
    got = color.apply_color_correction(method, torch.from_numpy(content), torch.from_numpy(style))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=LAB_ATOL if method == "lab" else COLOR_ATOL, rtol=0)
    if method != "none":
        assert np.abs(ref - content).max() > 0.05  # the method changed the frames


@pytest.mark.parametrize("conversion", ["lab", "hsv"])
def test_color_space_round_trips_match_jax(conversion):
    rgb = (_images(2) + 1.0) * 0.5
    to, back = {"lab": ("rgb_to_lab", "lab_to_rgb"), "hsv": ("rgb_to_hsv", "hsv_to_rgb")}[conversion]
    fwd_ref = np.asarray(getattr(jcolor, to)(jnp.asarray(rgb)))
    fwd = getattr(color, to)(torch.from_numpy(rgb))
    np.testing.assert_allclose(fwd.numpy(), fwd_ref, atol=LAB_ATOL if conversion == "lab" else COLOR_ATOL, rtol=0)
    np.testing.assert_allclose(getattr(color, back)(fwd).numpy(), np.asarray(getattr(jcolor, back)(jnp.asarray(fwd_ref))),
                               atol=COLOR_ATOL, rtol=0)


def test_histogram_matching_matches_jax():
    rs = np.random.RandomState(3)
    src, ref = rs.randn(500).astype(np.float32), (rs.randn(700) * 2 + 1).astype(np.float32)
    np.testing.assert_array_equal(color.histogram_match(torch.from_numpy(src), torch.from_numpy(ref[:500])).numpy(),
                                  np.asarray(jcolor.histogram_match(jnp.asarray(src), jnp.asarray(ref[:500]))))
    src_mask, ref_mask = rs.rand(500) > 0.4, rs.rand(700) > 0.5
    for lo in (0, 400):  # enough valid values on both sides / too few in the source
        sm = src_mask & (np.arange(500) >= lo)
        got = color.masked_histogram_match(*map(torch.from_numpy, (src, sm, ref, ref_mask)))
        want = jcolor.masked_histogram_match(*map(jnp.asarray, (src, sm, ref, ref_mask)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("overlap", [1, 2, 3, 4, 5])
def test_overlap_weights_and_blend_match_jax(overlap):
    np.testing.assert_array_equal(blending.overlap_weights(overlap), jblending.overlap_weights(overlap))
    prev, cur = _images(4, (overlap, 6, 5, 3)), _images(5, (overlap, 6, 5, 3))
    got = blending.blend_overlapping_frames(torch.from_numpy(prev), torch.from_numpy(cur), overlap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jblending.blend_overlapping_frames(jnp.asarray(prev), jnp.asarray(cur), overlap)))


# --------------------------------------------------------------------------- #
# The run budget
# --------------------------------------------------------------------------- #


class _Weights:
    """A runner as far as the budget reads one: resident weight bytes."""

    device = torch.device("cpu")

    def __init__(self, n):
        self.n = n

    def weight_bytes(self):
        return self.n


@pytest.mark.parametrize("hbm_gib,weights_gib", [(16, 0), (16, 7.3), (80, 7.3), (80, 40)])
def test_run_budget_decisions_match_jax(monkeypatch, hbm_gib, weights_gib):
    """Both packages are handed the same device memory size (explicitly: the
    port would read the card, JAX its device's limit) and the same resident
    weights, over 720p / 1080p / 4K shape points, short and long clips,
    both colour settings and both decode modes."""
    hbm = int(hbm_gib * 2**30)
    monkeypatch.setattr(jphases, "_hbm_bytes", lambda: hbm)
    monkeypatch.setattr(phases, "_hbm_bytes", lambda device: hbm)
    runner = _Weights(int(weights_gib * 2**30))
    seen = set()
    for (th, tw), total, colour, tiled in [
        (dims, total, colour, tiled)
        for dims in ((720, 1280), (1080, 1920), (2160, 3840))
        for total in (5, 121, 1201)
        for colour in ("wavelet", "none")
        for tiled in (False, True)
    ]:
        kw = dict(batch_size=5, color_correction=colour, decode_tiled=tiled)
        jcfg, pcfg = PipelineConfig(**kw), config.PipelineConfig(**kw)
        jctx, pctx = jphases.make_context(jcfg), phases.make_context(pcfg)
        for ctx, mod, cfg in ((jctx, jphases, jcfg), (pctx, phases, pcfg)):
            ctx.update(true_dims=(th, tw), total_frames=total,
                       batches=[None] * len(mod.batching.compute_batches(total, 5, 0, False)))
        want = jphases._run_budget(jcfg, jctx, runner)
        got = phases._run_budget(pcfg, pctx, runner)
        assert got == want, (th, tw, total, colour, tiled)
        assert phases._offload(pcfg, pctx, runner) == jphases._offload(jcfg, jctx, runner)
        assert phases._stash_color_ref(pcfg, pctx, runner) == jphases._stash_color_ref(jcfg, jctx, runner)
        seen.add((got["offload"], got["stash"]))
    assert len(seen) >= 2  # the shape points reach more than one decision


def test_hbm_bytes_of_a_cpu_device_is_the_jax_default():
    assert phases._hbm_bytes("cpu") == 16 << 30


# --------------------------------------------------------------------------- #
# phases.generate through the 4-phase path
# --------------------------------------------------------------------------- #

TILES = dict(encode_tiled=True, decode_tiled=True, encode_tile_size=(32, 32), encode_tile_overlap=(16, 16),
             decode_tile_size=(32, 32), decode_tile_overlap=(16, 16))


def _cfgs(**kw):
    vc, pvc = vae_tiny(), config.vae_tiny()
    dc = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    pdc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                              vid_out_channels=vc.latent_channels)
    base = dict(resolution=32, batch_size=5, compute_dtype="float32", **kw)
    jcfg, pcfg = PipelineConfig(dit=dc, vae=vc, **base), config.PipelineConfig(dit=pdc, vae=pvc, **base)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    dit_p = _perturbed(init_dit(jcfg.dit, jax.random.PRNGKey(0)), 1)
    vae_p = _perturbed(init_vae_params(jcfg.vae, jax.random.PRNGKey(1)), 2)
    # Decoded frames inside [-1, 1]: a clipped pixel ties with every other
    # clipped one, the histogram methods order ties by position, and one
    # code of fp32 summation noise then moves a pixel to the far end of a
    # tie (a 1e-6 perturbation moved hsv by 0.41 at full scale).
    for leaf in ("w", "b"):
        vae_p["decoder"]["conv_out"][leaf] = vae_p["decoder"]["conv_out"][leaf] * np.float32(0.2)
    text = (np.random.RandomState(3).randn(4, jcfg.dit.txt_in_dim) * 0.1).astype(np.float32)
    return dit_p, vae_p, text


def _jax_noise(cfg, frames):
    """The JAX step's per-batch noise for a 5-frame batch (2 latent frames):
    split(batch_key(seed, 'dit')) -> normal(k1, latent.shape[1:])."""
    h, w = side_resize_dims(frames.shape[1], frames.shape[2], cfg.resolution, cfg.max_resolution)
    k1, _ = jax.random.split(batch_key(cfg.seed, "dit"))
    return np.array(jax.random.normal(k1, (2, -(-h // 16) * 2, -(-w // 16) * 2, cfg.vae.latent_channels), np.float32))


# (settings, frames): every batch is 5 frames after 4n+1 padding, so one
# noise draw serves all of them, as in the JAX package.
CASES = {
    "overlap2-hann-hsv": (dict(temporal_overlap=2, color_correction="hsv"), 13),
    "overlap3-tiled": (dict(temporal_overlap=3, **TILES), 9),
    "prepend2-adain": (dict(prepend_frames=2, color_correction="adain"), 8),
    "tiled-fused": (dict(TILES), 9),
    "offload-always": (dict(tensor_offload="always"), 9),
    "fused-off-lab": (dict(fused_pipeline="off", color_correction="lab"), 9),
    "phased-weights-wavelet-adaptive": (dict(phased_weights=True, color_correction="wavelet_adaptive"), 9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax(weights, case):
    kw, t = CASES[case]
    jcfg, pcfg = _cfgs(**kw)
    dit_p, vae_p, text = weights
    frames = np.random.RandomState(t).rand(t, 24, 20, 3).astype(np.float32)
    ref = jphases.generate(JRunner(jcfg, jax.tree.map(jnp.asarray, dit_p), jax.tree.map(jnp.asarray, vae_p), text), frames)
    runner = Runner(pcfg, dit_from_jax(dit_p, pcfg.dit, "cpu", torch.float32),
                    vae_from_jax(vae_p, pcfg.vae, "cpu", torch.float32), text, device="cpu")
    got = phases.generate(runner, frames, noise=torch.from_numpy(_jax_noise(jcfg, frames)))
    assert got.shape == ref.shape == (t, 38, 32, 3) and got.dtype == ref.dtype
    if pcfg.color_correction in ("lab", "hsv", "wavelet_adaptive"):
        diff = np.abs(got - ref)
        assert (diff <= ATOL).mean() >= 0.995 and diff.max() <= 2e-3, (float((diff > ATOL).mean()), float(diff.max()))
    else:
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_generate_packed_on_the_4_phase_path(weights):
    """fused_pipeline="off" without overlap packs on the device (uint16), as
    the JAX package; with overlap the output is float32 in both."""
    dit_p, vae_p, text = weights
    frames = np.random.RandomState(5).rand(5, 24, 20, 3).astype(np.float32)
    noise = None
    for kw, dtype in ((dict(fused_pipeline="off"), np.uint16), (dict(temporal_overlap=2), np.float32)):
        jcfg, pcfg = _cfgs(**kw)
        noise = torch.from_numpy(_jax_noise(jcfg, frames))
        ref = jphases.generate(JRunner(jcfg, jax.tree.map(jnp.asarray, dit_p), jax.tree.map(jnp.asarray, vae_p), text),
                               frames, packed=True)
        runner = Runner(pcfg, dit_from_jax(dit_p, pcfg.dit, "cpu", torch.float32),
                        vae_from_jax(vae_p, pcfg.vae, "cpu", torch.float32), text, device="cpu")
        got = phases.generate(runner, frames, packed=True, noise=noise)
        assert got.dtype == ref.dtype == dtype
        assert np.abs(got.astype(np.float64) - ref.astype(np.float64)).max() <= (ATOL * 65535 if dtype == np.uint16 else ATOL)


def test_phased_weights_moves_the_dit_off_and_back(weights):
    dit_p, vae_p, text = weights
    _, pcfg = _cfgs(phased_weights=True)
    runner = Runner(pcfg, dit_from_jax(dit_p, pcfg.dit, "cpu", torch.float32),
                    vae_from_jax(vae_p, pcfg.vae, "cpu", torch.float32), text, device="cpu")
    runner.device = torch.device("meta")  # a device the weights are not on: release and residency are visible
    runner.release_dit()
    assert next(runner.dit.buffers()).device.type == "cpu"
    runner.ensure_dit_resident()
    assert next(runner.dit.buffers()).device.type == "meta"
