"""Resize, pad and normalise (counterpart of seedvr2_tpu/ops/resize.py).

The reference transform is NaResize(side) -> clamp -> DivisiblePad(16) ->
Normalize(0.5, 0.5). The resize is PIL/torch-antialias bicubic (a=-0.5),
applied as two dense fp32 matmuls with host-built weight matrices.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
        np.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a, 0.0),
    )


@lru_cache(maxsize=256)
def resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] fp32 separable bicubic weights matching
    F.interpolate(mode='bicubic', align_corners=False, antialias=True)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = _cubic_kernel((np.arange(xmin, xmax, dtype=np.float64) - center + 0.5) / fscale)
        s = w.sum()
        if s != 0.0:
            w = w / s
        m[i, xmin:xmax] = w.astype(np.float32)
    return m


def side_resize_dims(
    h: int, w: int, resolution: int, max_resolution: int = 0, downsample_only: bool = False
) -> Tuple[int, int]:
    """Shortest side to ``resolution`` (long side floors, as torchvision),
    then cap the longest at ``max_resolution`` with round()."""
    size = min(h, w) if (downsample_only and min(h, w) < resolution) else resolution
    short, long_ = (h, w) if h <= w else (w, h)
    new_short, new_long = size, int(size * long_ / short)
    th, tw = (new_short, new_long) if h <= w else (new_long, new_short)
    if max_resolution > 0 and max(th, tw) > max_resolution:
        scale = max_resolution / max(th, tw)
        th, tw = round(th * scale), round(tw * scale)
    return th, tw


def true_target_dims(h: int, w: int, resolution: int, max_resolution: int = 0) -> Tuple[int, int]:
    """Output dims before padding, rounded down to even for codecs."""
    th, tw = side_resize_dims(h, w, resolution, max_resolution)
    return (th // 2) * 2, (tw // 2) * 2


def resize_video(video: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[T, H, W, C] -> [T, size[0], size[1], C], fp32 matmuls."""
    mh = torch.from_numpy(resample_matrix(video.shape[1], size[0])).to(video.device)
    mw = torch.from_numpy(resample_matrix(video.shape[2], size[1])).to(video.device)
    y = torch.einsum("hH,tHwc->thwc", mh, video.float())
    return torch.einsum("wW,thWc->thwc", mw, y).to(video.dtype)


def to_f01(v: torch.Tensor) -> torch.Tensor:
    """Device frames -> fp32 [0, 1]: uint8 / 255, 16-bit codes / 65535
    (uint16 frames travel as int32), floats as they are."""
    f = v.float()
    if v.dtype == torch.uint8:
        return f / 255.0
    if v.dtype in (torch.int32, torch.uint16):
        return f / 65535.0
    return f


def divisible_pad(video: torch.Tensor, factor: int = 16) -> torch.Tensor:
    """Zero-pad H and W (bottom/right) up to a multiple of ``factor``."""
    ph, pw = (-video.shape[1]) % factor, (-video.shape[2]) % factor
    if ph == 0 and pw == 0:
        return video
    return F.pad(video, (0, 0, 0, pw, 0, ph))


def pipeline_transform(
    video: torch.Tensor, resolution: int, max_resolution: int = 0, divisible: int = 16
) -> torch.Tensor:
    """[T, H, W, C] in [0, 1] -> resized, clamped, padded, in [-1, 1]."""
    th, tw = side_resize_dims(video.shape[1], video.shape[2], resolution, max_resolution)
    out = resize_video(video, (th, tw)).clamp(0.0, 1.0)
    return divisible_pad(out, divisible) * 2.0 - 1.0
