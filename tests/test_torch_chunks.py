"""The streamed column-chunk decode and the deferred output copy of the port
(seedvr2_tpu_torch/models/vae/tiling.py:column_chunk_plan,
pipeline/runner.py:fused_batch_chunks, pipeline/phases.py:generate_streaming)
against the JAX package, on tiny configs (vae_tiny + dit_tiny, fp32, the
same weights, text and DiT noise: JAX's draw, handed to the port).

- column_chunk_plan equals JAX's field for field over a grid of shapes,
  the published 720p and 1080p plans and every rejection guard among them.
- phases.generate on the chunk route equals JAX's chunked generate at the
  JAX tests' geometry (5 x 24 x 96 -> 64 x 256, three column tiles), and
  the port's "off" route; packed u8, yuv420 planes, a column-tiled encode,
  the out-of-memory rung, a three-batch clip through the deferred flush
  and the routing gates.

Tolerance: 2/65535 + 1e-4 on [0, 1] outputs, as the JAX package's own
chunk tests (two 16-bit codes, plus fp32 summation noise between the
packages); packed codes and yuv420 planes within 1 code.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.config import PipelineConfig, dit_tiny, vae_config, vae_tiny
from seedvr2_tpu.models.dit.nadit import init_params as init_dit
from seedvr2_tpu.models.vae import tiling as jtiling
from seedvr2_tpu.models.vae.model import init_vae_params
from seedvr2_tpu.ops.resize import side_resize_dims
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu.pipeline.runner import Runner as JRunner
from seedvr2_tpu.utils.seed import batch_key
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io.weights import dit_from_jax, vae_from_jax
from seedvr2_tpu_torch.models.vae import tiling
from seedvr2_tpu_torch.ops.yuv import is_planar
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.pipeline.runner import Runner
from seedvr2_tpu_torch.stream_ab import overlap_us, union_us
from seedvr2_tpu_torch.utils.transfer import HostCopies

ATOL = 2.0 / 65535 + 1e-4
FIELDS = ("sf", "lt_w", "cols", "tw", "th", "ramp", "halo", "emit", "true_w")

# --------------------------------------------------------------------------- #
# The plan
# --------------------------------------------------------------------------- #


def _plans(H, W, tile, overlap, true_h, true_w, halo, vae=None):
    vc, pvc = (vae or vae_config)(), (getattr(config, (vae or vae_config).__name__))()
    ref = jtiling.column_chunk_plan(vc, H, W, tile, overlap, true_h, true_w, halo)
    got = tiling.column_chunk_plan(pvc, H, W, tile, overlap, true_h, true_w, halo)
    if ref is None:
        assert got is None
        return None
    assert got is not None
    assert tuple(getattr(got, f) for f in FIELDS) == tuple(
        tuple(v) if isinstance(v, (list, tuple)) else v for v in (getattr(ref, f) for f in FIELDS))
    return got


# (latent H, W, tile, overlap, true_h, true_w, halo) -> the expected cols and emit, or None
NAMED_PLANS = {
    # 720p under --vae_decode_tiled at the default 1024 / 128 tiles
    "720p": ((90, 160, (1024, 1024), (128, 128), 720, 1280, 32), ((0, 72), (544, 1280))),
    # 1080p with --vae_decode_tile_size 1088 1024
    "1080p-1088": ((136, 240, (1088, 1024), (128, 128), 1080, 1920, 32), ((0, 112), (864, 1920))),
    # 1080p at the default tiles: two tile rows
    "1080p-default": ((136, 240, (1024, 1024), (128, 128), 1080, 1920, 32), None),
    # the tiny geometry of the pipeline tests below, with and without the colour halo
    "tiny-wavelet": ((8, 32, (64, 128), (0, 32), 64, 256, 32), ((0, 9, 18), (40, 112, 256))),
    "tiny-none": ((8, 32, (64, 128), (0, 32), 64, 256, 0), ((0, 9, 18), (72, 144, 256))),
    # one column tile
    "one-column": ((8, 12, (64, 128), (0, 32), 64, 96, 32), None),
    # a halo past the true width: the interior boundary's halo would be replicate-padded
    "halo-past-true-w": ((8, 32, (64, 128), (0, 32), 64, 140, 32), None),
    # chunks too narrow for the halo: emit would not advance
    "halo-too-wide": ((8, 32, (64, 128), (0, 32), 64, 256, 80), None),
    # the true frame taller than the tile row
    "true-h-past-the-row": ((8, 32, (64, 128), (0, 32), 72, 256, 32), None),
    # wavelet_blur's min(H, W) // 8 clamp differs between a 72 px chunk and the 256 px frame
    "radius-clamp": ((32, 32, (256, 128), (0, 32), 256, 256, 32), None),
    # the same grid without a colour fix
    "radius-clamp-no-halo": ((32, 32, (256, 128), (0, 32), 256, 256, 0), ((0, 9, 18), (72, 144, 256))),
}


@pytest.mark.parametrize("name", list(NAMED_PLANS))
def test_named_plans_equal_jax(name):
    args, want = NAMED_PLANS[name]
    vae = vae_tiny if name.startswith(("tiny", "one", "halo", "true", "radius")) else vae_config
    got = _plans(*args, vae=vae)
    if want is None:
        assert got is None
    else:
        assert (got.cols, got.emit) == want


@pytest.mark.parametrize("halo", [0, 32])
@pytest.mark.parametrize("tile_w", [128, 256, 512, 1024])
def test_plan_grid_equals_jax(halo, tile_w):
    """Every latent shape of a grid at one tile width: rows of 1 and 2
    tiles, 1 to 4 columns, overlaps from none to past the tile, true sizes
    cut at the right and bottom."""
    seen = 0
    for H in (8, 16, 45, 90, 136):
        for W in (16, 40, 64, 90, 160, 240, 330):
            for ov in (0, 32, 64, 128, 2048):
                for cut_h, cut_w in ((0, 0), (6, 14), (0, 40)):
                    true_h, true_w = H * 8 - cut_h, W * 8 - cut_w
                    if true_h > 0 and true_w > 0:
                        seen += _plans(H, W, (1024, tile_w), (128, ov), true_h, true_w, halo) is not None
    assert seen > 0


# --------------------------------------------------------------------------- #
# The chunk route
# --------------------------------------------------------------------------- #

CHUNKED = dict(decode_tiled=True, decode_tile_size=(64, 128), decode_tile_overlap=(0, 32), resolution=64)


def _cfgs(**kw):
    vc, pvc = vae_tiny(), config.vae_tiny()
    dc = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    pdc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                              vid_out_channels=vc.latent_channels)
    base = dict(dict(batch_size=5, compute_dtype="float32", color_correction="wavelet", **CHUNKED), **kw)
    jcfg, pcfg = PipelineConfig(dit=dc, vae=vc, **base), config.PipelineConfig(dit=pdc, vae=pvc, **base)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves])


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    dit_p = _perturbed(init_dit(jcfg.dit, jax.random.PRNGKey(0)), 1)
    vae_p = _perturbed(init_vae_params(jcfg.vae, jax.random.PRNGKey(1)), 2)
    for leaf in ("w", "b"):  # decoded frames inside [-1, 1]: no clipped ties
        vae_p["decoder"]["conv_out"][leaf] = vae_p["decoder"]["conv_out"][leaf] * np.float32(0.2)
    text = (np.random.RandomState(3).randn(4, jcfg.dit.txt_in_dim) * 0.1).astype(np.float32)
    return dit_p, vae_p, text


def _runner(weights, pcfg):
    dit_p, vae_p, text = weights
    return Runner(pcfg, dit_from_jax(dit_p, pcfg.dit, "cpu", torch.float32),
                  vae_from_jax(vae_p, pcfg.vae, "cpu", torch.float32), text, device="cpu")


def _noise(cfg, frames):
    """The JAX step's noise of a 5-frame batch (2 latent frames)."""
    h, w = side_resize_dims(frames.shape[1], frames.shape[2], cfg.resolution, cfg.max_resolution)
    k1, _ = jax.random.split(batch_key(cfg.seed, "dit"))
    return torch.from_numpy(np.array(jax.random.normal(
        k1, (2, -(-h // 16) * 2, -(-w // 16) * 2, cfg.vae.latent_channels), np.float32)))


def _frames(t, seed):
    return np.random.RandomState(seed).rand(t, 24, 96, 3).astype(np.float32)


def _off(runner):
    return runner.with_config(runner.cfg.replace(chunked_output="off"))


def _spy_routes(monkeypatch, runner):
    """Count the batches each route runs on ``runner``."""
    seen = {"chunks": 0, "fused": 0}
    chunks, fused = runner.fused_batch_chunks, runner.fused_batch

    def count_chunks(*a, **k):
        seen["chunks"] += 1
        return chunks(*a, **k)

    def count_fused(*a, **k):
        seen["fused"] += 1
        return fused(*a, **k)

    monkeypatch.setattr(runner, "fused_batch_chunks", count_chunks)
    monkeypatch.setattr(runner, "fused_batch", count_fused)
    return seen


@pytest.mark.parametrize("color", ["wavelet", "none"])
def test_chunked_generate_matches_jax(weights, color, monkeypatch):
    jcfg, pcfg = _cfgs(color_correction=color)
    dit_p, vae_p, text = weights
    frames = _frames(5, 17)
    jrunner = JRunner(jcfg, jax.tree.map(jnp.asarray, dit_p), jax.tree.map(jnp.asarray, vae_p), text)
    jplan = jrunner.supports_chunked((5, 24, 96, 3), 64, 256)
    assert jplan is not None and len(jplan.cols) == 3
    ref = jphases.generate(jrunner, frames, jcfg)
    runner = _runner(weights, pcfg)
    plan = runner.supports_chunked((5, 24, 96, 3), 64, 256)
    assert plan is not None and len(plan.cols) == 3  # else this test would run the monolithic route
    seen = _spy_routes(monkeypatch, runner)
    got = phases.generate(runner, frames, noise=_noise(jcfg, frames))
    assert seen == {"chunks": 1, "fused": 0}
    assert got.shape == ref.shape == (5, 64, 256, 3) and got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    off = phases.generate(_off(runner), frames, noise=_noise(jcfg, frames))
    np.testing.assert_allclose(got, off, atol=ATOL, rtol=0)


def test_chunked_packed_u8_within_a_code(weights):
    jcfg, pcfg = _cfgs(output_bits=8)
    runner, frames = _runner(weights, pcfg), _frames(5, 19)
    got = phases.generate(runner, frames, packed=True, noise=_noise(jcfg, frames))
    ref = phases.generate(_off(runner), frames, packed=True, noise=_noise(jcfg, frames))
    assert got.dtype == ref.dtype == np.uint8 and got.shape == (5, 64, 256, 3)
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("bits", [8, 16])
def test_chunked_yuv420_planes_match_the_whole_frame(weights, bits):
    """Chunk planes (chroma at lo // 2 : hi // 2, every emit even) against
    the planes of the whole frame; an unpacked caller gets RGB converted
    from the batch's whole planes."""
    jcfg, pcfg = _cfgs(output_pixfmt="yuv420", output_bits=bits)
    runner, frames = _runner(weights, pcfg), _frames(5, 31)
    plan = runner.supports_chunked(frames.shape, 64, 256)
    assert runner._yuv_chunks_ok(plan, 64) and all(e % 2 == 0 for e in plan.emit)
    got = phases.generate(runner, frames, packed=True, noise=_noise(jcfg, frames))
    ref = phases.generate(_off(runner), frames, packed=True, noise=_noise(jcfg, frames))
    assert is_planar(got) and is_planar(ref) and got.depth == ref.depth == (8 if bits == 8 else 10)
    for a, b in zip((got.y, got.u, got.v), (ref.y, ref.u, ref.v)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    rgb = phases.generate(runner, frames, noise=_noise(jcfg, frames))
    rgb_off = phases.generate(_off(runner), frames, noise=_noise(jcfg, frames))
    assert rgb.shape == (5, 64, 256, 3) and rgb.dtype == np.float32
    np.testing.assert_allclose(rgb, rgb_off, atol=ATOL, rtol=0)


def test_chunk_route_gates(weights):
    """lab (not spatially local), chunked_output "off", an untiled decode,
    decode_tile_batch 2, a mesh and a disabled route give no plan."""
    _, pcfg = _cfgs()
    runner = _runner(weights, pcfg)
    shape = (5, 24, 96, 3)
    assert runner.supports_chunked(shape, 64, 256) is not None
    for kw in (dict(color_correction="lab"), dict(chunked_output="off"), dict(decode_tiled=False),
               dict(decode_tile_batch=2)):
        assert runner.with_config(pcfg.replace(**kw)).supports_chunked(shape, 64, 256) is None, kw
    meshed = runner.with_config(pcfg)
    meshed.mesh = object()  # any mesh: its segments stream whole
    assert meshed.supports_chunked(shape, 64, 256) is None
    runner._disable_chunked = True
    assert runner.supports_chunked(shape, 64, 256) is None


def test_chunked_with_a_column_tiled_encode_agrees_on_all_routes(weights):
    enc = dict(encode_tiled=True, encode_tile_size=(64, 128), encode_tile_overlap=(0, 32))
    jcfg, pcfg = _cfgs(**enc)
    runner, frames = _runner(weights, pcfg), _frames(5, 29)
    assert len(tiling._axis_grid(256 // 8, 128 // 8, 32 // 8)[1]) >= 2
    assert runner.supports_chunked(frames.shape, 64, 256) is not None
    got = phases.generate(runner, frames, noise=_noise(jcfg, frames))
    off = phases.generate(_off(runner), frames, noise=_noise(jcfg, frames))
    phased = phases.generate(runner.with_config(pcfg.replace(fused_pipeline="off")), frames,
                             noise=_noise(jcfg, frames))
    np.testing.assert_allclose(got, off, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, phased, atol=ATOL, rtol=0)


def test_chunk_route_oom_retries_monolithic_once(weights, monkeypatch, capsys):
    jcfg, pcfg = _cfgs()
    runner, frames = _runner(weights, pcfg), _frames(5, 23)
    ref = phases.generate(_runner(weights, pcfg), frames, noise=_noise(jcfg, frames))
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    seen = _spy_routes(monkeypatch, runner)
    monkeypatch.setattr(runner, "fused_batch_chunks", boom)
    got = phases.generate(runner, frames, noise=_noise(jcfg, frames))
    assert calls["n"] == 1 and runner._disable_chunked
    assert seen["fused"] == 1  # the monolithic fused route, not the 4-phase ladder
    assert "retrying the fused pipeline" in capsys.readouterr().out
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_chunk_route_oom_twice_reaches_the_4_phase_path(weights, monkeypatch, capsys):
    jcfg, pcfg = _cfgs()
    runner, frames = _runner(weights, pcfg), _frames(5, 23)

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(runner, "fused_batch_chunks", boom)
    monkeypatch.setattr(runner, "fused_batch", boom)
    got = phases.generate(runner, frames, noise=_noise(jcfg, frames))
    out = capsys.readouterr().out
    assert "retrying the fused pipeline" in out and "falling back to the phase-wise path" in out
    ref = phases.generate(runner.with_config(pcfg.replace(fused_pipeline="off")), frames,
                          noise=_noise(jcfg, frames))
    np.testing.assert_array_equal(got, ref)


def test_other_errors_on_the_chunk_route_propagate(weights, monkeypatch):
    _, pcfg = _cfgs()
    runner = _runner(weights, pcfg)

    def boom(*a, **k):
        raise ValueError("not an out-of-memory error")

    monkeypatch.setattr(runner, "fused_batch_chunks", boom)
    with pytest.raises(ValueError):
        phases.generate(runner, _frames(5, 3))
    assert not runner._disable_chunked


def test_three_batches_through_the_deferred_flush(weights, monkeypatch):
    """15 frames in three 5-frame batches: batch i is flushed after batch
    i+1 is queued, and the clip equals the "off" route's."""
    jcfg, pcfg = _cfgs()
    runner = _runner(weights, pcfg)
    frames = np.concatenate([_frames(5, s) for s in (41, 42, 43)])
    events = []
    chunks, landed = runner.fused_batch_chunks, phases._landed

    def queued(*a, **k):
        events.append("queue")
        yield from chunks(*a, **k)

    monkeypatch.setattr(runner, "fused_batch_chunks", queued)
    monkeypatch.setattr(phases, "_landed", lambda c: events.append("flush") or landed(c))
    noise = _noise(jcfg, frames[:5])
    got = phases.generate(runner, frames, noise=noise)
    flushes = ["flush"] * 3  # three column chunks a batch
    assert events == ["queue", "queue"] + flushes + ["queue"] + flushes + flushes
    ref = phases.generate(_off(runner), frames, noise=noise)
    assert got.shape == (15, 64, 256, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_host_copies_on_a_cpu_device_read_the_tensor_where_it_lies():
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    copy = HostCopies("cpu").start(t)
    assert copy.wait() is t


def test_trace_interval_arithmetic():
    """stream_ab's busy time (a union of intervals) and copy overlap (the
    part of each copy under the union of the compute kernels)."""
    assert union_us([(5, 6), (0, 2), (1, 3), (3, 4)]) == 5.0
    assert union_us([]) == 0.0
    kernels = [(1, 2), (1.5, 3), (8, 12), (20, 21)]
    assert overlap_us([(0, 10)], kernels) == 4.0
    assert overlap_us([(2.5, 9), (11, 30)], kernels) == 0.5 + 1.0 + 1.0 + 1.0
    assert overlap_us([(4, 7)], kernels) == 0.0
