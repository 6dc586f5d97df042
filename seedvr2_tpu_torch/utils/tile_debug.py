"""The ``--tile_debug`` overlay (the port's copy of
seedvr2_tpu/utils/tile_debug.py): each VAE tile's rectangle and index drawn
on the output frames, on the grid that models/vae/tiling.py runs, so that
tile size and overlap can be tuned by eye. Host-side numpy and cv2."""

from __future__ import annotations

import colorsys
import math
from typing import List, Tuple

import numpy as np


def tile_boundaries(
    height: int,
    width: int,
    tile_size: Tuple[int, int],
    tile_overlap: Tuple[int, int],
    spatial_downsample: int = 8,
) -> List[dict]:
    """Pixel-space rectangles of the tile grid models/vae/tiling.py runs
    (the equalised grid of _axis_grid, with its hard-seam guard)."""
    from ..models.vae.tiling import _axis_grid, effective_pixel_overlap

    sf = spatial_downsample
    H_lat, W_lat = math.ceil(height / sf), math.ceil(width / sf)
    ltmax_h, ltmax_w = max(1, tile_size[0] // sf), max(1, tile_size[1] // sf)
    ov_h = effective_pixel_overlap(tile_overlap[0], H_lat, ltmax_h, sf)
    ov_w = effective_pixel_overlap(tile_overlap[1], W_lat, ltmax_w, sf)
    lo_h = max(0, min(ov_h // sf, ltmax_h - 1))
    lo_w = max(0, min(ov_w // sf, ltmax_w - 1))
    if H_lat <= ltmax_h and W_lat <= ltmax_w:
        return []
    lt_h, rows = _axis_grid(H_lat, ltmax_h, lo_h)
    lt_w, cols = _axis_grid(W_lat, ltmax_w, lo_w)
    out = []
    tid = 0
    for y in rows:
        for x in cols:
            tid += 1
            out.append(
                {
                    "id": tid,
                    "x": x * sf,
                    "y": y * sf,
                    "w": min(lt_w * sf, width - x * sf),
                    "h": min(lt_h * sf, height - y * sf),
                }
            )
    return out


def draw_for_config(frames01: np.ndarray, cfg, which: str) -> np.ndarray:
    """Annotate output frames with the encode or decode tile grid ``cfg``
    runs (the CLI's --tile_debug)."""
    tiled = cfg.encode_tiled if which == "encode" else cfg.decode_tiled
    if not tiled:
        return frames01
    ts = cfg.encode_tile_size if which == "encode" else cfg.decode_tile_size
    to = cfg.encode_tile_overlap if which == "encode" else cfg.decode_tile_overlap
    # the VAE ran on the frames padded to a multiple of 16: the grid is theirs
    hp = -(-frames01.shape[1] // 16) * 16
    wp = -(-frames01.shape[2] // 16) * 16
    bounds = tile_boundaries(hp, wp, ts, to, cfg.vae.spatial_downsample_factor)
    return draw_tile_boundaries(frames01, bounds)


def draw_tile_boundaries(frames01: np.ndarray, boundaries: List[dict]) -> np.ndarray:
    """frames01: [T, H, W, C] in [0,1]. Returns annotated copy."""
    if not boundaries:
        return frames01
    import cv2

    T, H, W, C = frames01.shape
    scale = max(0.0, min(1.0, (W - 512) / (1920 - 512)))
    thickness = int(2 + scale * 4)
    font_scale = 0.8 + scale * 1.7

    colors = []
    n = len(boundaries)
    for i in range(n):
        hue = (i * 360 / n) % 360
        r, g, b = colorsys.hsv_to_rgb(hue / 360, 0.9, 0.9)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))

    out = []
    for t in range(T):
        img = np.ascontiguousarray((frames01[t, :, :, :3] * 255).astype(np.uint8))
        for i, bd in enumerate(boundaries):
            x, y, w, h = bd["x"], bd["y"], bd["w"], bd["h"]
            cv2.rectangle(img, (x, y), (x + w - 1, y + h - 1), colors[i], thickness)
            cv2.putText(
                img, str(bd["id"]), (x + 8, y + 24 + int(10 * scale)),
                cv2.FONT_HERSHEY_SIMPLEX, font_scale, colors[i], 2, cv2.LINE_AA,
            )
        frame = img.astype(np.float32) / 255.0
        if C == 4:
            frame = np.concatenate([frame, frames01[t, :, :, 3:]], axis=-1)
        out.append(frame)
    return np.stack(out)
