"""Temporal-overlap blending windows (counterpart of
seedvr2_tpu/ops/blending.py): a Hann crossfade over the middle third of the
overlap for overlap >= 3, linear otherwise."""

from __future__ import annotations

import numpy as np
import torch


def overlap_weights(overlap: int) -> np.ndarray:
    """Weight of the *previous* batch over the overlap region."""
    if overlap >= 3:
        t = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
        u = np.clip((t - 1.0 / 3.0) / (1.0 / 3.0), 0.0, 1.0)
        return (0.5 + 0.5 * np.cos(np.pi * u)).astype(np.float32)
    return np.linspace(1.0, 0.0, overlap, dtype=np.float32)


def blend_overlapping_frames(prev_tail: torch.Tensor, cur_head: torch.Tensor, overlap: int) -> torch.Tensor:
    """prev_tail/cur_head: [overlap, H, W, C]."""
    w_prev = torch.from_numpy(overlap_weights(overlap)).reshape(overlap, 1, 1, 1).to(prev_tail.device, prev_tail.dtype)
    return prev_tail * w_prev + cur_head * (1.0 - w_prev)
