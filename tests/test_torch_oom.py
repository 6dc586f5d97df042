"""The out-of-memory ladder of the port (pipeline/runner.py:
_with_oom_fallback, phases.generate's fused -> 4-phase fallback) and the
host-staged tiled decode (models/vae/tiling.py:tiled_decode_staged)
against the JAX package.

- The ladder's attempts, fed the same scripted failures, equal the JAX
  runner's (torch.cuda.OutOfMemoryError here, RESOURCE_EXHAUSTED there),
  and so do the forced log lines; anything else is not retried.
- tiled_decode_staged equals the port's device-tiled decode on the CPU
  (fp32, atol 1e-5: the same tiles and ramps, the sums taken elsewhere)
  and JAX's tiled_decode_staged on the same weights (atol 1e-4, rtol
  1e-4: fp32 conv stacks of two libraries).
- The fused fallback's output equals the 4-phase run's (tolerance 0: the
  same code on the same runner).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.config import vae_tiny
from seedvr2_tpu.models.vae import model as jmodel
from seedvr2_tpu.models.vae import tiling as jtiling
from seedvr2_tpu.pipeline.runner import Runner as JRunner
from seedvr2_tpu.utils.debug import Debug as JDebug
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io.weights import random_dit, random_vae, vae_from_jax
from seedvr2_tpu_torch.models.vae import tiling
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.pipeline.runner import Runner
from seedvr2_tpu_torch.utils.debug import Debug

STAGED_TOL = dict(atol=1e-5, rtol=0)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)

# --------------------------------------------------------------------------- #
# The ladder's rungs
# --------------------------------------------------------------------------- #

# (tiled, tile_size, tile_overlap) a VAE call starts from
STARTS = [(False, (512, 512), (64, 64)), (True, (1024, 1024), (128, 128)), (True, (512, 512), (64, 64)),
          (True, (256, 256), (32, 32)), (True, (768, 640), (96, 80))]


def _scripted(fails: int, error):
    """A VAE call that fails its first ``fails`` attempts with ``error`` and
    records every attempt's (tiled, tile_size, tile_overlap)."""
    attempts = []

    def fn(tiled, ts, to):
        attempts.append((tiled, tuple(ts), tuple(to)))
        if len(attempts) <= fails:
            raise error()
        return np.zeros((1, 2))

    return fn, attempts


def _ladder(runner, tag, start, fails, error, capsys):
    fn, attempts = _scripted(fails, error)
    staged = []

    def staged_fn(ts, to):
        staged.append((tuple(ts), tuple(to)))
        return "staged"

    try:
        out = runner._with_oom_fallback(tag, fn, *start, staged_fn=staged_fn if tag == "decode" else None)
        result = "staged" if isinstance(out, str) else "ok"
    except (torch.cuda.OutOfMemoryError, RuntimeError):
        result = "raised"
    return attempts, staged, result, capsys.readouterr().out


def _port_runner():
    r = object.__new__(Runner)
    r.debug, r.device = Debug(), torch.device("cpu")
    return r


def _jax_runner():
    r = object.__new__(JRunner)
    r.debug, r._oom_validated = JDebug(), set()
    return r


@pytest.mark.parametrize("tag", ["encode", "decode"])
@pytest.mark.parametrize("start", STARTS, ids=lambda s: f"{'tiled' if s[0] else 'untiled'}{s[1][0]}x{s[1][1]}")
def test_ladder_attempts_equal_jax(tag, start, capsys):
    """Every number of scripted failures, from 0 to past the last rung: the
    same attempts, the same staged rung, the same outcome, the same log."""

    def oom():
        return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    def exhausted():
        return RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate 2.00GiB")

    outcomes = set()
    for fails in range(8):
        got = _ladder(_port_runner(), tag, start, fails, oom, capsys)
        ref = _ladder(_jax_runner(), tag, start, fails, exhausted, capsys)
        assert got == ref, (fails, got, ref)
        assert got[3].count("\n") == len(got[0]) - 1 + (got[2] == "staged")  # one forced line a rung
        outcomes.add(got[2])
    assert outcomes == ({"ok", "staged"} if tag == "decode" else {"ok", "raised"})


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: an illegal memory access was encountered"),
                                   ValueError("bad shape"), MemoryError()], ids=type)
def test_ladder_does_not_retry_other_errors(error, capsys):
    attempts = []

    def fn(tiled, ts, to):
        attempts.append(tiled)
        raise error

    with pytest.raises(type(error)):
        _port_runner()._with_oom_fallback("decode", fn, False, (512, 512), (64, 64), staged_fn=lambda ts, to: None)
    assert attempts == [False] and capsys.readouterr().out == ""


# --------------------------------------------------------------------------- #
# The host-staged decode
# --------------------------------------------------------------------------- #


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


@pytest.fixture(scope="module")
def tiny():
    cfg = vae_tiny()
    params = _perturbed(jmodel.init_vae_params(cfg, jax.random.PRNGKey(0)), 1)
    return cfg, params, vae_from_jax(params, cfg, "cpu", torch.float32)


# latent 6x8 (48x64 px): a 2x3 grid of 4x4 latent tiles with 16 px seams; an H axis whose zero
# overlap the grid outgrows (the hard-seam guard) beside a W axis of one
# tile; one tile covering everything
GRIDS = {"2x3": ((32, 32), (16, 16)), "zero-overlap": ((32, 64), (0, 16)), "one-tile": ((64, 64), (16, 16))}


@pytest.mark.parametrize("grid,T", [("2x3", 3), ("zero-overlap", 2), ("one-tile", 2)])
def test_staged_decode_equals_tiled_decode_and_jax(tiny, grid, T):
    cfg, params, vae = tiny
    size, overlap = GRIDS[grid]
    z = np.random.RandomState(3).randn(1, T, 6, 8, cfg.latent_channels).astype(np.float32)
    got = tiling.tiled_decode_staged(vae, torch.from_numpy(z), size, overlap)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert got.shape == (1, 4 * (T - 1) + 1, 48, 64, 3)
    tiled = tiling.tiled_decode(vae, torch.from_numpy(z), size, overlap)
    np.testing.assert_allclose(got.numpy(), tiled.numpy(), **STAGED_TOL)
    ref = jtiling.tiled_decode_staged(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(z), size, overlap)
    np.testing.assert_allclose(got.numpy(), ref, **JAX_TOL)


def test_staged_decode_holds_one_tile_on_the_device(tiny):
    """Every tile decode sees one tile's latent; the accumulator is host
    memory (the output leaves on the CPU whatever the latent's device)."""
    cfg, _, vae = tiny
    seen = []
    orig = tiling.slicing_decode

    def spy(v, zt):
        seen.append(tuple(zt.shape[2:4]))
        return orig(v, zt)

    z = torch.from_numpy(np.random.RandomState(4).randn(1, 2, 6, 8, cfg.latent_channels).astype(np.float32))
    mp = pytest.MonkeyPatch()
    mp.setattr(tiling, "slicing_decode", spy)
    try:
        tiling.tiled_decode_staged(vae, z, *GRIDS["2x3"])
    finally:
        mp.undo()
    assert seen == [(4, 4)] * 6  # a 2 x 3 grid of 4 x 4 latent tiles


# --------------------------------------------------------------------------- #
# The ladder in a runner, and generate's fallback
# --------------------------------------------------------------------------- #


def _tiny_runner(**cfg_kw):
    vc = config.vae_tiny()
    dc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    cfg = config.PipelineConfig(dit=dc, vae=vc, resolution=32, compute_dtype="float32", **cfg_kw)
    g = torch.Generator().manual_seed(5)
    text = np.random.RandomState(6).randn(4, dc.txt_in_dim).astype(np.float32)
    return Runner(cfg, random_dit(dc, g, torch.float32), random_vae(vc, g, torch.float32), text, device="cpu")


def _oom_while(runner, stage, when):
    """Make the runner's raw ``stage`` ("_encode" / "_decode") raise
    torch.cuda.OutOfMemoryError on attempts where ``when(tiled, ts)``."""
    raw = getattr(runner, stage)

    def patched(x, tiled, ts, to, tile_parallel=True):
        if when(tiled, ts):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (scripted)")
        return raw(x, tiled, ts, to, tile_parallel)

    setattr(runner, stage, patched)


def test_decode_ladder_reaches_the_staged_rung(capsys):
    """Every device-tiled attempt fails: the decode is the host-staged one
    at the floor tile (256 px, overlap 32), moved back to the latent's
    device in fp32."""
    runner = _tiny_runner()
    lat = torch.from_numpy(np.random.RandomState(7).randn(1, 2, 40, 44, 4).astype(np.float32))
    _oom_while(runner, "_decode", lambda tiled, ts: True)
    got = runner.vae_decode(lat)
    vc = runner.cfg.vae
    ref = tiling.tiled_decode_staged(runner.vae, lat / vc.scaling_factor + vc.shifting_factor, (256, 256), (32, 32))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    out = capsys.readouterr().out
    assert out.count("retrying with tiles") == 3 and "host-staged" in out


@pytest.mark.parametrize("route", [{}, {"temporal_overlap": 2}])
def test_fused_route_falls_back_to_the_4phase_route(route, capsys):
    """An OOM in the fused route's encode reruns the clip on the 4-phase
    route, whose encode then climbs the ladder (untiled fails, tiled
    passes): the output is the 4-phase route's at those tiles."""
    frames = np.random.RandomState(8).rand(7, 20, 24, 3).astype(np.float32)
    runner = _tiny_runner(**route)
    _oom_while(runner, "_encode", lambda tiled, ts: not tiled)
    got = phases.generate(runner, frames)
    ref_runner = _tiny_runner(fused_pipeline="off", encode_tiled=True, **route)
    ref = phases.generate(ref_runner, frames)
    np.testing.assert_array_equal(got, ref)
    out = capsys.readouterr().out
    fused = not route
    assert out.count("HBM exhausted in the fused pipeline") == int(fused)
    assert out.count("HBM exhausted during VAE encode; retrying with tiles (1024, 1024)") == 2  # two batches


def test_generate_does_not_catch_other_errors():
    runner = _tiny_runner()

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: device-side assert triggered")

    runner.fused_batch = broken
    with pytest.raises(RuntimeError, match="device-side assert"):
        phases.generate(runner, np.zeros((5, 20, 24, 3), np.float32))


@pytest.mark.parametrize("fails", list(itertools.product([False, True], repeat=2)), ids=str)
def test_ladder_passes_the_config_tiles_through(fails):
    """Without an OOM a VAE call runs once at the config's tiles (encode and
    decode independently)."""
    runner = _tiny_runner(encode_tiled=fails[0], decode_tiled=fails[1], encode_tile_size=(32, 32),
                          decode_tile_size=(32, 32), encode_tile_overlap=(16, 16), decode_tile_overlap=(16, 16))
    calls = []
    for stage in ("_encode", "_decode"):
        raw = getattr(runner, stage)

        def rec(x, tiled, ts, to, tile_parallel=True, _raw=raw, _stage=stage):
            calls.append((_stage, tiled, tuple(ts), tuple(to)))
            return _raw(x, tiled, ts, to, tile_parallel)

        setattr(runner, stage, rec)
    video = torch.from_numpy(np.tanh(np.random.RandomState(9).randn(1, 5, 32, 48, 3)).astype(np.float32))
    runner.vae_decode(runner.vae_encode(video))
    assert calls == [("_encode", fails[0], (32, 32), (16, 16)), ("_decode", fails[1], (32, 32), (16, 16))]
