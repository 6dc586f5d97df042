"""The port's tiled VAE vs the JAX package's (seedvr2_tpu/models/vae/
tiling.py): the grid helpers over a range of sizes (exact: the same numpy
code), and tiled encode/decode of vae_tiny with perturbed weights on
multi-tile grids with sizes that are not multiples of the tile or of 8,
tile_batch 1 and 2, and an axis whose zero overlap the grid outgrows.

Tolerance for the VAE outputs atol=5e-4, rtol=5e-4, as tests/test_torch_vae.py:
deep fp32 conv stacks accumulate order differences; the blending itself is
the same fp32 arithmetic in the same order.
"""

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
from seedvr2_tpu_torch.io.weights import vae_from_jax
from seedvr2_tpu_torch.models.vae import tiling

TOL = dict(atol=5e-4, rtol=5e-4)


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


@pytest.mark.parametrize("tile_max", [1, 4, 16, 64, 128])
def test_grid_helpers_equal(tile_max):
    for total, overlap in itertools.product(range(1, 300, 7), (0, 1, 2, 3, 16, 200)):
        got, ref = tiling._axis_grid(total, tile_max, overlap), jtiling._axis_grid(total, tile_max, overlap)
        assert got == ref, (total, tile_max, overlap)
        tile, starts = got
        assert tiling._seam_ramp(tile, starts, overlap) == jtiling._seam_ramp(tile, starts, overlap)
        assert tiling._tile_starts(total, tile_max, max(1, tile_max - overlap)) == jtiling._tile_starts(
            total, tile_max, max(1, tile_max - overlap))
        for sf in (1, 8):
            assert tiling.effective_pixel_overlap(overlap, total, tile_max, sf) == jtiling.effective_pixel_overlap(
                overlap, total, tile_max, sf)
    for n, ov in itertools.product(range(1, 40), range(0, 12)):
        np.testing.assert_array_equal(tiling._cosine_ramp(ov), jtiling._cosine_ramp(ov))
        for a, b in itertools.product((False, True), repeat=2):
            np.testing.assert_array_equal(tiling._edge_weights(n, ov, a, b), jtiling._edge_weights(n, ov, a, b))


@pytest.fixture(scope="module")
def tiny():
    cfg = vae_tiny()
    params = _perturbed(jmodel.init_vae_params(cfg, jax.random.PRNGKey(0)), 1)
    return cfg, params, vae_from_jax(params, cfg, "cpu", torch.float32)


# (tile size, overlap) in pixels on a 44x60 clip (latent 6x8, padded from 5.5x7.5):
# a 2x2 grid of 4x4 latent tiles with 2-latent seams; then an H axis whose
# overlap of 0 the grid outgrows (so it gets the default 128 px, clamped to
# the tile) beside a W axis that fits one tile.
GRIDS = {"2x2": ((32, 32), (16, 16)), "zero-overlap": ((32, 64), (0, 16))}


@pytest.mark.parametrize("grid,tile_batch", [("2x2", 1), ("2x2", 2), ("zero-overlap", 1)])
def test_tiled_encode_matches_jax(tiny, grid, tile_batch):
    cfg, params, vae = tiny
    size, overlap = GRIDS[grid]
    x = np.tanh(np.random.RandomState(2).randn(1, 5, 44, 60, 3).astype(np.float32))
    ref = np.asarray(jtiling.vae_encode(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(x), True, size, overlap, tile_batch))
    got = tiling.vae_encode(vae, torch.from_numpy(x), True, size, overlap, tile_batch)
    assert got.shape == ref.shape == (1, 2, 6, 8, cfg.latent_channels)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("grid,tile_batch,T", [("2x2", 1, 2), ("2x2", 2, 3), ("zero-overlap", 2, 2)])
def test_tiled_decode_matches_jax(tiny, grid, tile_batch, T):
    """T=3 latent frames decode as two temporal slices inside every tile;
    with tile_batch 2 on three or four tiles the last group is short."""
    cfg, params, vae = tiny
    size, overlap = GRIDS[grid]
    z = np.random.RandomState(3).randn(1, T, 6, 8, cfg.latent_channels).astype(np.float32)
    ref = np.asarray(jtiling.vae_decode(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(z), True, size, overlap, tile_batch))
    got = tiling.vae_decode(vae, torch.from_numpy(z), True, size, overlap, tile_batch)
    assert got.shape == ref.shape == (1, 4 * (T - 1) + 1, 48, 64, 3)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_tiled_blend_weights_cover_every_pixel():
    """No pixel of a multi-tile output is left with zero blend weight (the
    ramps are clamped to the smallest seam), at the decode grid of the
    1080p long-clip configuration (latent 136x240, tiles 1024/128 px)."""
    sf, lt = 8, 1024 // 8
    lt_h, rows = tiling._axis_grid(136, lt, 16)
    lt_w, cols = tiling._axis_grid(240, lt, 16)
    assert (len(rows), len(cols)) == (2, 2)
    th, tw = lt_h * sf, lt_w * sf
    weights = tiling._grid_weights(th, tw, rows, cols, tiling._seam_ramp(th, [y * sf for y in rows], 128),
                                   tiling._seam_ramp(tw, [x * sf for x in cols], 128))
    cnt = np.zeros((136 * sf, 240 * sf), np.float32)
    for (y, x), w in zip([(y, x) for y in rows for x in cols], weights):
        cnt[y * sf : y * sf + th, x * sf : x * sf + tw] += w
    assert cnt.min() > 0.5
