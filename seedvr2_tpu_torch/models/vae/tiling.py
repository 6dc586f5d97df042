"""VAE encode/decode drivers (counterpart of seedvr2_tpu/models/vae/tiling.py).

- Temporal slicing: a clip longer than slicing_*_min_size runs as slices,
  the first in "init" mode, the rest in "active" mode consuming the
  streaming carries: numerically a single pass.
- Spatial tiling (``tiled=True``): an equalised uniform tile grid in latent
  coordinates, each tile encoded or decoded (sliced in time as above),
  blended with separable cosine ramps on interior edges into fp32
  accumulators on the device, divided by the accumulated weight.

The JAX package runs the tile groups as one ``lax.scan`` and pads the last
group with zero-weight duplicates so that every step has one shape; here
the groups are a Python loop and the last group is simply shorter. The
column-chunk streaming decode (ColumnChunkPlan, tiled_decode_staged) is
not ported yet (ROADMAP.md queue 1).

Tile parallelism (``shard=TileShard(...)``, the counterpart of the JAX
package's ``tile_sharding``): rank r of n runs the tiles whose index is r
mod n, blends them into its own fp32 accumulator, and the accumulators are
summed over the group; the blend weights (host math) are summed on every
rank. Where there are fewer tiles than ranks, a rank without a tile runs
no VAE pass: it takes the output's frame and channel counts from rank 0
(which always holds tile 0) and adds a zero accumulator to the sum.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...config import VAEConfig
from ...parallel.comm import all_reduce_sum
from .causal_conv import StreamCtx
from .model import VAE, posterior_mode

# --------------------------------------------------------------------------- #
# Temporal slicing
# --------------------------------------------------------------------------- #


def _temporal_slices(T: int, first: int, rest: int):
    """First frame plus ``rest`` frames, then chunks of ``rest``."""
    bounds = [(0, min(1 + rest, T))]
    s = 1 + rest
    while s < T:
        bounds.append((s, min(s + rest, T)))
        s += rest
    return bounds


def _sliced(forward, x: torch.Tensor, split: int) -> torch.Tensor:
    T = x.shape[1]
    if (T - 1) <= split:
        return forward(x, StreamCtx("disabled"))
    outs, state = [], {}
    for i, (s, e) in enumerate(_temporal_slices(T, 1, split)):
        ctx = StreamCtx("init" if i == 0 else "active", state)
        outs.append(forward(x[:, s:e], ctx))
        state = ctx.out_state
    return torch.cat(outs, dim=1)


def slicing_encode(vae: VAE, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, W, 3] (T = 4n+1) -> moments [B, n+1, H/8, W/8, 2C]."""
    return _sliced(vae.encoder, x, vae.cfg.slicing_sample_min_size)


def slicing_decode(vae: VAE, z: torch.Tensor) -> torch.Tensor:
    """z [B, T', H', W', C] -> [B, 4(T'-1)+1, 8H', 8W', 3]."""
    return _sliced(vae.decoder, z, vae.cfg.slicing_latent_min_size)


# --------------------------------------------------------------------------- #
# Spatial tiling: grid helpers (copies of the JAX package's numpy helpers)
# --------------------------------------------------------------------------- #


def _cosine_ramp(n: int) -> np.ndarray:
    """Exact cosine fade, linspace(0, 1) endpoints included; the ramp length
    is clamped to the smallest seam (_seam_ramp), so where one tile's ramp
    reaches zero the neighbouring tile is at full weight."""
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    return 0.5 - 0.5 * np.cos(t * np.pi)


def _seam_ramp(tile: int, starts: list, overlap: int) -> int:
    """Blend-ramp length for one axis: the configured overlap clamped to the
    smallest actual seam overlap of the grid (_axis_grid rounds interior
    starts, so a seam can be one short of the overlap)."""
    r = max(0, min(overlap, tile - 1))
    for a, b in zip(starts, starts[1:]):
        r = min(r, a + tile - b)
    return max(0, r)


def _tile_starts(total: int, tile: int, stride: int) -> list:
    """Uniform full-size tile starts covering [0, total): stride steps with the
    last start clamped to ``total - tile``."""
    if total <= tile:
        return [0]
    starts = list(range(0, total - tile, stride))
    starts.append(total - tile)
    return starts


def effective_pixel_overlap(ov: int, extent_lat: int, ltmax: int, sf: int) -> int:
    """Pixel overlap for one axis after the hard-seam guard: an overlap that
    floors to zero latent overlap on an axis that still needs more than one
    tile gets the default blended 128 px back."""
    if extent_lat > ltmax and ov // sf <= 0:
        return 128
    return ov


def _axis_grid(total: int, tile_max: int, overlap: int) -> Tuple[int, list]:
    """Equalised tile grid for one axis (latent coordinates): the tile count
    of the naive grid, every tile shrunk to the least size that still covers
    with >= ``overlap``. Returns (tile, starts)."""
    if total <= tile_max:
        return total, [0]
    overlap = min(overlap, tile_max - 1)
    n = math.ceil((total - overlap) / (tile_max - overlap))
    tile = math.ceil((total + (n - 1) * overlap) / n)
    starts = [round(i * (total - tile) / (n - 1)) for i in range(n)]
    return tile, starts


def _edge_weights(n: int, ov: int, at_start_edge: bool, at_end_edge: bool) -> np.ndarray:
    w = np.ones(n, dtype=np.float32)
    ov = max(0, min(ov, n - 1))
    if ov > 0:
        ramp = _cosine_ramp(ov)
        if not at_start_edge:
            w[:ov] = ramp
        if not at_end_edge:
            w[-ov:] = 1.0 - ramp
    return w


# --------------------------------------------------------------------------- #
# Spatial tiling: drivers
# --------------------------------------------------------------------------- #


def _grid_weights(tile_h: int, tile_w: int, rows: list, cols: list, r_h: int, r_w: int) -> List[np.ndarray]:
    """Per-tile blend weights (interior edges only), row-major tile order."""
    out = []
    for y in rows:
        for x in cols:
            wh = _edge_weights(tile_h, r_h, y == 0, y == rows[-1])
            ww = _edge_weights(tile_w, r_w, x == 0, x == cols[-1])
            out.append(np.outer(wh, ww))
    return out


class TileShard(NamedTuple):
    """Rank ``rank`` of the ``size`` ranks of ``group`` that share the tiles."""

    rank: int
    size: int
    group: object


def _blend_tiles(
    run: Callable[[torch.Tensor], torch.Tensor],  # [B*g, T, th_in, tw_in, Cin] -> [B*g, T2, th_out, tw_out, Cout]
    tile_in: List[torch.Tensor],  # per tile [B, T, th_in, tw_in, Cin] (views)
    weights: List[np.ndarray],  # per tile [th_out, tw_out]
    out_starts: List[Tuple[int, int]],  # per tile output-space (y, x)
    out_hw: Tuple[int, int],
    tile_batch: int,
    shard: Optional[TileShard] = None,
) -> torch.Tensor:
    """Run the tiles ``tile_batch`` at a time (B major within a group, as the
    JAX package's scan body) and blend each into fp32 acc/cnt on the device;
    returns acc / max(cnt, 1e-6) in fp32. With ``shard``, this rank's tiles
    only, then the sum of every rank's acc (module docstring)."""
    B, dev = tile_in[0].shape[0], tile_in[0].device
    H, W = out_hw
    mine = list(range(len(tile_in)))
    if shard is not None:
        mine = mine[shard.rank :: shard.size]
    cnt = torch.zeros((1, 1, H, W, 1), dtype=torch.float32, device=dev)
    for i, (y, x) in enumerate(out_starts):  # every tile's weight, on every rank
        th, tw = weights[i].shape
        cnt[:, :, y : y + th, x : x + tw] += torch.from_numpy(weights[i]).to(dev)[None, None, :, :, None]
    acc = None
    for g0 in range(0, len(mine), tile_batch):
        ids = mine[g0 : g0 + tile_batch]
        group = [tile_in[i] for i in ids]
        g = len(group)
        out = run(torch.stack(group, dim=1).reshape((B * g,) + tuple(group[0].shape[1:])))
        out = out.reshape((B, g) + tuple(out.shape[1:]))
        if acc is None:
            acc = torch.zeros((B, out.shape[2], H, W, out.shape[-1]), dtype=torch.float32, device=dev)
        th, tw = out.shape[3], out.shape[4]
        for gi, i in enumerate(ids):
            w = torch.from_numpy(weights[i]).to(dev)[None, None, :, :, None]
            y, x = out_starts[i]
            acc[:, :, y : y + th, x : x + tw] += out[:, gi].float() * w
        del out
    if shard is not None:
        if len(tile_in) < shard.size:  # some rank holds no tile: rank 0 sends (frames, channels)
            tc = torch.tensor([acc.shape[1], acc.shape[4]] if shard.rank == 0 else [0, 0], device=dev)
            t_out, c_out = (int(v) for v in all_reduce_sum(tc, shard.group))
            if acc is None:
                acc = torch.zeros((B, t_out, H, W, c_out), dtype=torch.float32, device=dev)
        acc = all_reduce_sum(acc, shard.group)
    return acc / cnt.clamp_min(1e-6)


def tiled_encode(
    vae: VAE,
    x: torch.Tensor,
    tile_size: Tuple[int, int] = (512, 512),
    tile_overlap: Tuple[int, int] = (64, 64),
    tile_batch: int = 1,
    shard: Optional[TileShard] = None,
) -> torch.Tensor:
    """Spatial tiling in latent coordinates; tile and overlap are pixel
    values. x [B, T, H, W, 3] -> moments [B, T', ceil(H/8), ceil(W/8), 2C]
    in x's dtype."""
    B, T, H, W, _ = x.shape
    sf = vae.cfg.spatial_downsample_factor
    ltmax_h, ltmax_w = max(1, tile_size[0] // sf), max(1, tile_size[1] // sf)
    H_lat, W_lat = math.ceil(H / sf), math.ceil(W / sf)
    if H <= tile_size[0] and W <= tile_size[1]:
        return slicing_encode(vae, x)
    ov_h = effective_pixel_overlap(tile_overlap[0], H_lat, ltmax_h, sf)
    ov_w = effective_pixel_overlap(tile_overlap[1], W_lat, ltmax_w, sf)
    lo_h = max(0, min(ov_h // sf, ltmax_h - 1))
    lo_w = max(0, min(ov_w // sf, ltmax_w - 1))
    lt_h, rows = _axis_grid(H_lat, ltmax_h, lo_h)
    lt_w, cols = _axis_grid(W_lat, ltmax_w, lo_w)
    tiles = [(y, x0) for y in rows for x0 in cols]
    weights = _grid_weights(lt_h, lt_w, rows, cols, _seam_ramp(lt_h, rows, lo_h), _seam_ramp(lt_w, cols, lo_w))

    # edge-pad to the latent grid's extent so every tile slice is full-size
    Hp, Wp = H_lat * sf, W_lat * sf
    if Hp != H:
        x = torch.cat([x, x[:, :, -1:].expand(-1, -1, Hp - H, -1, -1)], dim=2)
    if Wp != W:
        x = torch.cat([x, x[:, :, :, -1:].expand(-1, -1, -1, Wp - W, -1)], dim=3)
    tile_in = [x[:, :, y * sf : (y + lt_h) * sf, x0 * sf : (x0 + lt_w) * sf] for (y, x0) in tiles]
    result = _blend_tiles(lambda b: slicing_encode(vae, b), tile_in, weights, tiles, (H_lat, W_lat), tile_batch, shard)
    return result.to(x.dtype)


def tiled_decode(
    vae: VAE,
    z: torch.Tensor,
    tile_size: Tuple[int, int] = (512, 512),
    tile_overlap: Tuple[int, int] = (64, 64),
    tile_batch: int = 1,
    shard: Optional[TileShard] = None,
) -> torch.Tensor:
    """A uniform full-size latent tile grid (_axis_grid), each tile decoded
    and blended in pixel space with ramps clamped to the smallest actual
    pixel seam. z [B, T', H', W', C] -> [B, 4(T'-1)+1, 8H', 8W', 3] in z's
    dtype."""
    B, T, H, W, _ = z.shape
    sf = vae.cfg.spatial_downsample_factor
    ltmax_h, ltmax_w = max(1, tile_size[0] // sf), max(1, tile_size[1] // sf)
    if H <= ltmax_h and W <= ltmax_w:
        return slicing_decode(vae, z)
    ov_h = effective_pixel_overlap(tile_overlap[0], H, ltmax_h, sf)
    ov_w = effective_pixel_overlap(tile_overlap[1], W, ltmax_w, sf)
    lo_h = max(0, min(ov_h // sf, ltmax_h - 1))
    lo_w = max(0, min(ov_w // sf, ltmax_w - 1))
    lt_h, rows = _axis_grid(H, ltmax_h, lo_h)
    lt_w, cols = _axis_grid(W, ltmax_w, lo_w)
    tiles = [(y, x) for y in rows for x in cols]
    th, tw = lt_h * sf, lt_w * sf
    r_h = _seam_ramp(th, [y * sf for y in rows], ov_h)
    r_w = _seam_ramp(tw, [x * sf for x in cols], ov_w)
    weights = _grid_weights(th, tw, rows, cols, r_h, r_w)
    tile_in = [z[:, :, y : y + lt_h, x : x + lt_w] for (y, x) in tiles]
    starts = [(y * sf, x * sf) for (y, x) in tiles]
    result = _blend_tiles(lambda b: slicing_decode(vae, b), tile_in, weights, starts, (H * sf, W * sf), tile_batch,
                          shard)
    return result.to(z.dtype)


# --------------------------------------------------------------------------- #
# Top-level encode/decode with scale/shift (runner-facing)
# --------------------------------------------------------------------------- #


def vae_encode(
    vae: VAE,
    video: torch.Tensor,
    tiled: bool = False,
    tile_size: Tuple[int, int] = (512, 512),
    tile_overlap: Tuple[int, int] = (64, 64),
    tile_batch: int = 1,
    shard: Optional[TileShard] = None,
) -> torch.Tensor:
    """[B, T, H, W, 3] in [-1, 1] -> scaled latent (mode(z) - shift) * scale.
    ``shard`` splits the tiles of a tiled encode over ranks."""
    cfg: VAEConfig = vae.cfg
    moments = (tiled_encode(vae, video, tile_size, tile_overlap, tile_batch, shard) if tiled
               else slicing_encode(vae, video))
    return (posterior_mode(moments) - cfg.shifting_factor) * cfg.scaling_factor


def vae_decode(
    vae: VAE,
    latent: torch.Tensor,
    tiled: bool = False,
    tile_size: Tuple[int, int] = (512, 512),
    tile_overlap: Tuple[int, int] = (64, 64),
    tile_batch: int = 1,
    shard: Optional[TileShard] = None,
) -> torch.Tensor:
    cfg: VAEConfig = vae.cfg
    z = latent / cfg.scaling_factor + cfg.shifting_factor
    return tiled_decode(vae, z, tile_size, tile_overlap, tile_batch, shard) if tiled else slicing_decode(vae, z)
