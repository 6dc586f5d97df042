"""VAE encode/decode drivers (counterpart of seedvr2_tpu/models/vae/tiling.py).

- Temporal slicing: a clip longer than slicing_*_min_size runs as slices,
  the first in "init" mode, the rest in "active" mode consuming the
  streaming carries: numerically a single pass.
- Spatial tiling (``tiled=True``): an equalised uniform tile grid in latent
  coordinates, each tile encoded or decoded (sliced in time as above),
  blended with separable cosine ramps on interior edges into fp32
  accumulators on the device, divided by the accumulated weight.

- The host-staged decode (``tiled_decode_staged``): the same grid and
  ramps, one tile at a time on the device, the blend in host memory.
- The streamed column-chunk decode (``column_chunk_plan``): where the
  decode grid is one row of column tiles, the geometry with which
  pipeline/runner.py:fused_batch_chunks decodes the tiles left to right and
  emits each finished column range as soon as its tile is blended.

The JAX package runs the tile groups as one ``lax.scan`` and pads the last
group with zero-weight duplicates so that every step has one shape; here
the groups are a Python loop and the last group is simply shorter.

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
from ...utils.transfer import to_device
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
        cnt[:, :, y : y + th, x : x + tw] += to_device(weights[i], dev)[None, None, :, :, None]
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
            w = to_device(weights[i], dev)[None, None, :, :, None]
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


class _DecodeGrid(NamedTuple):
    """The decode tile grid of a latent: the latent (y, x) start of each
    tile (row-major), the latent tile size and each tile's pixel blend
    weights."""

    tiles: List[Tuple[int, int]]
    lt_h: int
    lt_w: int
    weights: List[np.ndarray]


def _decode_axis(extent: int, tile_px: int, overlap_px: int, sf: int) -> Tuple[int, list, int]:
    """One axis of tiled_decode's grid, hard-seam guard included: (latent
    tile size, latent starts of an equalised grid (_axis_grid), pixel ramp
    clamped to the smallest actual pixel seam)."""
    ltmax = max(1, tile_px // sf)
    ov = effective_pixel_overlap(overlap_px, extent, ltmax, sf)
    lt, starts = _axis_grid(extent, ltmax, max(0, min(ov // sf, ltmax - 1)))
    return lt, starts, _seam_ramp(lt * sf, [s * sf for s in starts], ov)


def _decode_grid(H: int, W: int, sf: int, tile_size: Tuple[int, int], tile_overlap: Tuple[int, int]) -> _DecodeGrid:
    """tiled_decode's grid (shared with tiled_decode_staged and
    column_chunk_plan)."""
    lt_h, rows, r_h = _decode_axis(H, tile_size[0], tile_overlap[0], sf)
    lt_w, cols, r_w = _decode_axis(W, tile_size[1], tile_overlap[1], sf)
    return _DecodeGrid([(y, x) for y in rows for x in cols], lt_h, lt_w,
                       _grid_weights(lt_h * sf, lt_w * sf, rows, cols, r_h, r_w))


class ColumnChunkPlan(NamedTuple):
    """The geometry of the streamed column-chunk decode
    (pipeline/runner.py:fused_batch_chunks): a single row of >= 2
    full-height column tiles, decoded left to right and chained by an
    (acc, cnt) carry strip, each emitting the packed columns that are final
    once it is blended. Pixel units unless noted."""

    sf: int
    lt_w: int  # latent tile width
    cols: Tuple[int, ...]  # latent column starts (>= 2)
    tw: int  # pixel tile width
    th: int  # pixel tile height (the full frame height)
    ramp: int  # seam blend ramp length
    halo: int  # colour-fix halo (0 when there is no colour fix)
    emit: Tuple[int, ...]  # chunk end columns; emit[-1] == true_w
    true_w: int

    def tile_weights(self, i: int) -> np.ndarray:
        """Column tile i's blend weights across its width, as tiled_decode
        weighs it (ramps on interior seams only)."""
        return _edge_weights(self.tw, self.ramp, i == 0, i == len(self.cols) - 1)


def column_chunk_plan(
    cfg: VAEConfig,
    H: int,  # latent rows of the decode input
    W: int,  # latent columns
    tile_size: Tuple[int, int],
    tile_overlap: Tuple[int, int],
    true_h: int,
    true_w: int,
    halo: int,
) -> Optional[ColumnChunkPlan]:
    """The ColumnChunkPlan of tiled_decode's own grid (_decode_axis), or
    None where streaming would change the result: the grid must be a
    single row of >= 2 column tiles, each interior boundary plus its halo
    must lie inside the true width (a halo cut at true_w would be
    replicate-padded where the whole frame has real pixels), and ``halo``
    must cover the colour fix's reach (wavelet: 5 levels of dilated 3x3,
    radii 1+2+4+8+16 = 31 -> 32). The radius-clamp guard rejects shapes
    where wavelet_blur's min(H, W) // 8 clamp (ops/color.py) would act
    otherwise on a halo'd chunk than on the whole frame."""
    sf = cfg.spatial_downsample_factor
    if H > max(1, tile_size[0] // sf):  # more than one tile row
        return None
    lt_w, cols, ramp = _decode_axis(W, tile_size[1], tile_overlap[1], sf)
    if len(cols) < 2:
        return None
    tw, th = lt_w * sf, H * sf
    if true_h > th or true_w > W * sf:
        return None
    p = [x * sf for x in cols]
    emit = []
    prev = 0
    for i in range(len(cols) - 1):
        e = p[i + 1] - halo
        if e <= prev or (halo and p[i + 1] > true_w) or e - halo < 0:
            return None
        emit.append(e)
        prev = e
    if true_w <= prev:
        return None
    emit.append(true_w)
    if halo:
        m_full = max(1, min(true_h, true_w) // 8)
        lo = 0
        for i, e in enumerate(emit):
            a = max(0, lo - (halo if i else 0))
            b = min(true_w, e + (halo if i < len(emit) - 1 else 0))
            m_chunk = max(1, min(true_h, b - a) // 8)
            if m_chunk != m_full and (m_chunk < 16 or m_full < 16):
                return None
            lo = e
    return ColumnChunkPlan(sf, lt_w, tuple(cols), tw, th, ramp, halo, tuple(emit), true_w)


def tiled_decode(
    vae: VAE,
    z: torch.Tensor,
    tile_size: Tuple[int, int] = (512, 512),
    tile_overlap: Tuple[int, int] = (64, 64),
    tile_batch: int = 1,
    shard: Optional[TileShard] = None,
) -> torch.Tensor:
    """A uniform full-size latent tile grid (_decode_grid), each tile
    decoded and blended in pixel space. z [B, T', H', W', C] -> [B,
    4(T'-1)+1, 8H', 8W', 3] in z's dtype."""
    B, T, H, W, _ = z.shape
    sf = vae.cfg.spatial_downsample_factor
    if H <= max(1, tile_size[0] // sf) and W <= max(1, tile_size[1] // sf):
        return slicing_decode(vae, z)
    grid = _decode_grid(H, W, sf, tile_size, tile_overlap)
    tile_in = [z[:, :, y : y + grid.lt_h, x : x + grid.lt_w] for (y, x) in grid.tiles]
    starts = [(y * sf, x * sf) for (y, x) in grid.tiles]
    result = _blend_tiles(lambda b: slicing_decode(vae, b), tile_in, grid.weights, starts, (H * sf, W * sf),
                          tile_batch, shard)
    return result.to(z.dtype)


def tiled_decode_staged(
    vae: VAE,
    z: torch.Tensor,  # [B, T', H', W', C] unscaled latent on the VAE's device
    tile_size: Tuple[int, int] = (1024, 1024),
    tile_overlap: Tuple[int, int] = (128, 128),
) -> torch.Tensor:
    """Host-staged tiled decode, the last rung of the decode OOM ladder
    (pipeline/runner.py): tiled_decode's grid and ramps, one tile at a time
    decoded on the device, weighted there, copied to host fp32 and added
    into one host accumulator. The device never holds more than one tile's
    activations and output besides the latent. Returns a host (CPU) fp32
    tensor in the decoder's range [-1, 1]; where the grid is one tile, that
    tile's decode. Counterpart of the JAX package's tiled_decode_staged."""
    B, T, H, W, _ = z.shape
    sf = vae.cfg.spatial_downsample_factor
    grid = _decode_grid(H, W, sf, tile_size, tile_overlap)
    acc = cnt = None
    for (y, x), w in zip(grid.tiles, grid.weights):
        w_dev = torch.from_numpy(w).to(z.device)[None, None, :, :, None]
        out = (slicing_decode(vae, z[:, :, y : y + grid.lt_h, x : x + grid.lt_w]).float() * w_dev).cpu()
        if acc is None:
            acc = torch.zeros((B, out.shape[1], H * sf, W * sf, out.shape[-1]), dtype=torch.float32)
            cnt = torch.zeros((1, 1, H * sf, W * sf, 1), dtype=torch.float32)
        th, tw = w.shape
        acc[:, :, y * sf : y * sf + th, x * sf : x * sf + tw] += out
        cnt[:, :, y * sf : y * sf + th, x * sf : x * sf + tw] += torch.from_numpy(w)[None, None, :, :, None]
        del out
    return acc / cnt.clamp_min(1e-6)


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
