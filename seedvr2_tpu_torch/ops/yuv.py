"""yuv420p <-> RGB: the planar frame container, the conversions on the card
and their numpy forms (counterpart of seedvr2_tpu/ops/yuv.py).

With ``--pixfmt yuv420`` the host link carries the codec's native planes
(1.5 codes a pixel instead of 3) and the colour conversion runs on the
card: a planar input is converted in ``ops/resize.py:to_f01``, and the
fused path packs the sink's planes in ``Runner.finalize_batch``.

Colorimetry: BT.601 limited range (Y 16..235, C 16..240 at 8 bits, x4 at
10 bits), the default of swscale for untagged rawvideo. Only sources that
are BT.601 limited range, or carry no colour tags, may take this path
(io/video.py:FFmpegReader decides from the probe). Chroma is the 2x2 box
mean on encode and a 2x bilinear upsample with half-pixel centres on
decode. 8-bit planes are uint8 codes; 10-bit planes are 10-bit codes in
uint16 on the host (yuv420p10le), int16 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.transfer import to_device

_KR, _KG, _KB = 0.299, 0.587, 0.114  # BT.601


def _ranges(depth: int):
    s = float(1 << (depth - 8))
    return 16.0 * s, 219.0 * s, 128.0 * s, 224.0 * s  # y0, yr, c0, cr


@dataclass
class PlanarYUV420:
    """yuv420p frames as three planes, y [T, H, W] and u, v [T, H/2, W/2]:
    numpy arrays on the host, tensors on the card. ``shape`` reads as the
    RGB frames' (T, H, W, 3), so the batch and geometry code needs no
    planar case."""

    y: Any
    u: Any
    v: Any
    depth: int = 8

    @property
    def shape(self):
        t, h, w = self.y.shape
        return (t, h, w, 3)

    @property
    def ndim(self):
        return 4

    def __len__(self):
        return self.y.shape[0]

    def tmap(self, fn) -> "PlanarYUV420":
        """The same frame-axis (axis 0) operation on every plane."""
        return PlanarYUV420(fn(self.y), fn(self.u), fn(self.v), self.depth)

    def __getitem__(self, key) -> "PlanarYUV420":
        if not isinstance(key, (slice, int)):
            raise TypeError("PlanarYUV420 indexes frames (axis 0) only")
        if isinstance(key, int):
            key = slice(key, key + 1 if key != -1 else None)
        return self.tmap(lambda p: p[key])

    def to_numpy(self) -> "PlanarYUV420":
        """Host planes: uint8 codes at 8 bits, uint16 at 10."""
        dt = np.uint8 if self.depth == 8 else np.uint16

        def host(p):
            a = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
            return a.astype(dt, copy=False)

        return self.tmap(host)

    def to_device(self, device) -> "PlanarYUV420":
        """Host planes -> the card, 8-bit codes as uint8, 10-bit as int16."""
        def dev(p):
            a = np.asarray(p)
            return to_device(a.astype(np.int16) if a.dtype == np.uint16 else a, device)

        return self.tmap(dev)

    def tobytes(self) -> bytes:
        """Frame-interleaved planar bytes (Y, U, V of each frame): what
        ffmpeg's rawvideo yuv420p / yuv420p10le demuxer reads."""
        host = self.to_numpy()
        parts = []
        for t in range(len(host)):
            parts += [np.ascontiguousarray(p[t]).tobytes() for p in (host.y, host.u, host.v)]
        return b"".join(parts)


def is_planar(x) -> bool:
    return isinstance(x, PlanarYUV420)


def yuv420_to_rgb01(frames: PlanarYUV420) -> torch.Tensor:
    """Planar codes (tensors) -> fp32 RGB [T, H, W, 3] in [0, 1]."""
    y0, yr, c0, cr = _ranges(frames.depth)
    t, h, w = frames.y.shape
    yp = (frames.y.float() - y0) / yr
    up = F.interpolate(((frames.u.float() - c0) / cr)[:, None], size=(h, w), mode="bilinear", align_corners=False)[:, 0]
    vp = F.interpolate(((frames.v.float() - c0) / cr)[:, None], size=(h, w), mode="bilinear", align_corners=False)[:, 0]
    r = yp + 1.402 * vp
    b = yp + 1.772 * up
    g = (yp - _KR * r - _KB * b) / _KG
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 1.0)


def rgb01_to_yuv420(rgb01: torch.Tensor, depth: int = 8) -> PlanarYUV420:
    """fp32 RGB [T, H, W, 3] in [0, 1] (H, W even) -> planar codes on the
    same device. Chroma is the 2x2 box mean of the per-pixel Pb / Pr."""
    t, h, w, _ = rgb01.shape
    y0, yr, c0, cr = _ranges(depth)
    r, g, b = rgb01[..., 0], rgb01[..., 1], rgb01[..., 2]
    yp = _KR * r + _KG * g + _KB * b
    pb = (b - yp) / 1.772
    pr = (r - yp) / 1.402
    y = y0 + yr * yp
    u = c0 + cr * pb.reshape(t, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    v = c0 + cr * pr.reshape(t, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    hi = float((1 << depth) - 1)
    dt = torch.uint8 if depth == 8 else torch.int16
    return PlanarYUV420(*(torch.round(p).clamp(0.0, hi).to(dt) for p in (y, u, v)), depth=depth)


# ------------------------------ numpy forms -------------------------------- #


def yuv420_to_rgb01_np(frames: PlanarYUV420) -> np.ndarray:
    """Host form of yuv420_to_rgb01 (the same half-pixel-centre bilinear
    chroma upsample)."""
    y0, yr, c0, cr = _ranges(frames.depth)
    t, h, w = frames.y.shape
    yp = (np.asarray(frames.y, np.float32) - y0) / yr
    up = _bilinear2x_np((np.asarray(frames.u, np.float32) - c0) / cr, h, w)
    vp = _bilinear2x_np((np.asarray(frames.v, np.float32) - c0) / cr, h, w)
    r = yp + 1.402 * vp
    b = yp + 1.772 * up
    g = (yp - _KR * r - _KB * b) / _KG
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def _bilinear2x_np(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """2x bilinear upsample with half-pixel centres, edges clamped."""
    t, hh, ww = p.shape
    yi = (np.arange(h, dtype=np.float32) + 0.5) / 2.0 - 0.5
    xi = (np.arange(w, dtype=np.float32) + 0.5) / 2.0 - 0.5
    y0i = np.clip(np.floor(yi).astype(np.int64), 0, hh - 1)
    x0i = np.clip(np.floor(xi).astype(np.int64), 0, ww - 1)
    y1i = np.clip(y0i + 1, 0, hh - 1)
    x1i = np.clip(x0i + 1, 0, ww - 1)
    fy = np.clip(yi - y0i, 0.0, 1.0)[None, :, None]
    fx = np.clip(xi - x0i, 0.0, 1.0)[None, None, :]
    a = p[:, y0i][:, :, x0i]
    b = p[:, y0i][:, :, x1i]
    c = p[:, y1i][:, :, x0i]
    d = p[:, y1i][:, :, x1i]
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx


def rgb01_to_yuv420_np(rgb01: np.ndarray, depth: int = 8) -> PlanarYUV420:
    """Host form of rgb01_to_yuv420 (uint8 / uint16 planes)."""
    t, h, w, _ = rgb01.shape
    y0, yr, c0, cr = _ranges(depth)
    r, g, b = rgb01[..., 0], rgb01[..., 1], rgb01[..., 2]
    yp = _KR * r + _KG * g + _KB * b
    pb = (b - yp) / 1.772
    pr = (r - yp) / 1.402
    y = y0 + yr * yp
    u = c0 + cr * pb.reshape(t, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    v = c0 + cr * pr.reshape(t, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    hi = float((1 << depth) - 1)
    dt = np.uint8 if depth == 8 else np.uint16
    return PlanarYUV420(*(np.clip(np.round(p), 0.0, hi).astype(dt) for p in (y, u, v)), depth=depth)
