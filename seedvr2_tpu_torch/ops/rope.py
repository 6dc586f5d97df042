"""Rotary position embeddings: the frequency tables, rebuilt in numpy, and
the GPT-J pairwise rotation (counterpart of seedvr2_tpu/ops/rope.py, whose
module imports jax).

3B "mmrope3d": lang-style inverse-theta frequencies; video token (t, h, w)
sits at axis positions (txt_len + t, h, w) and text token i at i on every
axis. 7B "window_pixel": linspace(1, max_freq/2) * pi frequencies over
positions linspace(-1, 1, n) per axis.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def rope_lang_freqs(num: int, theta: float = 10000.0) -> np.ndarray:
    """Per-axis frequencies of length 2*num: [f0, f0, f1, f1, ...]."""
    f = 1.0 / (theta ** (np.arange(0, 2 * num, 2, dtype=np.float64) / (2 * num)))
    return np.repeat(f, 2)


def rope_pixel_freqs(num: int, max_freq: float = 256.0) -> np.ndarray:
    f = np.linspace(1.0, max_freq / 2.0, num, dtype=np.float64) * np.pi
    return np.repeat(f, 2)


def _axial(dims: Tuple[int, ...], per_axis: np.ndarray, positions) -> np.ndarray:
    n = len(dims)
    freq_dim = per_axis.shape[0]
    parts = []
    for ax, d in enumerate(dims):
        ang = np.einsum("p,f->pf", positions(ax, d), per_axis)
        shape = [1] * n + [freq_dim]
        shape[ax] = d
        parts.append(np.broadcast_to(ang.reshape(shape), tuple(dims) + (freq_dim,)))
    return np.concatenate(parts, axis=-1).astype(np.float32)


@lru_cache(maxsize=64)
def axial_freqs_lang(
    dims: Tuple[int, ...], freq_dim: int, theta: float = 10000.0, offsets: Tuple[int, ...] = None
) -> np.ndarray:
    """[*dims, len(dims) * freq_dim] angles; ``offsets`` shifts positions per axis."""
    offsets = offsets or (0,) * len(dims)
    return _axial(
        dims, rope_lang_freqs(freq_dim // 2, theta),
        lambda ax, d: np.arange(d, dtype=np.float64) + offsets[ax],
    )


@lru_cache(maxsize=256)
def axial_freqs_pixel(dims: Tuple[int, ...], freq_dim: int, max_freq: float = 256.0) -> np.ndarray:
    return _axial(
        dims, rope_pixel_freqs(freq_dim // 2, max_freq),
        lambda ax, d: np.linspace(-1.0, 1.0, d) if d > 1 else np.array([-1.0]),
    )


def pad_angles(angles: np.ndarray, dim: int) -> np.ndarray:
    """Zero-pad angle tables to the full head dim: a zero angle is an exact
    identity rotation, so the padded lanes pass through unchanged."""
    r = angles.shape[-1]
    if r == dim:
        return angles
    return np.pad(angles, [(0, 0)] * (angles.ndim - 1) + [(0, dim - r)])


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """GPT-J pairwise rotation in fp32, (x0, x1) -> (x0 c - x1 s, x1 c + x0 s):
    rot[2i] = -x[2i+1], rot[2i+1] = x[2i]. Returns fp32."""
    xf = x.float()
    x2 = xf.unflatten(-1, (xf.shape[-1] // 2, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)
    return xf * cos + rot * sin


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the leading angles.shape[-1] channels of x; cast back to x.dtype."""
    r = angles.shape[-1]
    out = rotate(x[..., :r], torch.cos(angles), torch.sin(angles)).to(x.dtype)
    if r == x.shape[-1]:
        return out
    return torch.cat([out, x[..., r:]], dim=-1)
