"""Colour correction, wavelet path (counterpart of the wavelet part of
seedvr2_tpu/ops/color.py). Inputs and outputs are [-1, 1], channels-first
[B, C, H, W]; the math runs in fp32.

The blur is the 3x3 [1 2 1]^2/16 kernel, dilated, with replicate padding,
written as nine shifted fp32 adds rather than a depthwise conv: exact
fp32 on every device (a cuDNN fp32 conv may run in TF32) and memory-bound
either way.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_TAPS = ((0.0625, 0.125, 0.0625), (0.125, 0.25, 0.125), (0.0625, 0.125, 0.0625))


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    H, W = image.shape[-2:]
    radius = min(radius, max(1, min(H, W) // 8))
    x = F.pad(image, (radius, radius, radius, radius), mode="replicate")
    out = None
    for i in range(3):
        for j in range(3):
            tap = x[..., i * radius : i * radius + H, j * radius : j * radius + W] * _TAPS[i][j]
            out = tap if out is None else out + tap
    return out


def wavelet_decomposition(image: torch.Tensor, levels: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    high = torch.zeros_like(image)
    for i in range(levels):
        low = wavelet_blur(image, 2**i)
        high = high + image - low
        image = low
    return high, image


def wavelet_reconstruction(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Content high frequencies + style low frequencies, clamped to [-1, 1]."""
    c_high, _ = wavelet_decomposition(content.float())
    _, s_low = wavelet_decomposition(style.float())
    return (c_high + s_low).clamp(-1.0, 1.0).to(content.dtype)


SUPPORTED = ("wavelet", "none")


def apply_color_correction(method: str, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    if method == "wavelet":
        return wavelet_reconstruction(content, style)
    if method == "none":
        return content
    raise NotImplementedError(
        f"color_correction={method!r} is not ported yet (ROADMAP.md queue 1, 'the rest of the pipeline')"
    )
