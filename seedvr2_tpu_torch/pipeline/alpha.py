"""Edge-guided alpha upscaling of RGBA frames, in torch on the runner's
device (counterpart of seedvr2_tpu/pipeline/alpha.py).

The alpha channel never passes through the VAE or the DiT: phase 1 sets it
aside, and phase 4 upscales it with the torch-parity bicubic resize and
refines it with a guided filter whose guide is the upscaled RGB's grey
(gradient masks), or with Sobel edges of the upscaled RGB (binary masks).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_video


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over a (2r + 1)^2 window of [T, H, W], zero padding counted."""
    return F.avg_pool2d(x[:, None], 2 * r + 1, stride=1, padding=r, count_include_pad=True)[:, 0]


def sobel_edges(rgb01: torch.Tensor) -> torch.Tensor:
    """[T, H, W, 3] in [0, 1] -> edge magnitude [T, H, W] in [0, 1]: RGB
    truncated to 8-bit codes, Rec.601 grey rounded, 3x3 Sobel with
    reflect-101 borders, each frame normalised by its maximum and truncated
    to 8 bits (the reference's OpenCV pipeline)."""
    rgbq = torch.floor(rgb01.clamp(0, 1) * 255.0)
    gray = torch.round(rgbq[..., 0] * 0.299 + rgbq[..., 1] * 0.587 + rgbq[..., 2] * 0.114)
    g = F.pad(gray[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]

    def conv3(x, kx, ky):
        x = x[:, :, :-2] * kx[0] + x[:, :, 1:-1] * kx[1] + x[:, :, 2:] * kx[2]
        return x[:, :-2, :] * ky[0] + x[:, 1:-1, :] * ky[1] + x[:, 2:, :] * ky[2]

    sx = conv3(g, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0))
    sy = conv3(g, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0))
    mag = torch.sqrt(sx * sx + sy * sy)
    mx = mag.amax(dim=(1, 2), keepdim=True)
    mag = torch.floor(mag / mx.clamp_min(1e-8) * 255.0) / 255.0
    return mag.clamp(0.0, 1.0)


def guided_filter(guide_gray: torch.Tensor, src: torch.Tensor, radius: int, eps: float) -> torch.Tensor:
    """He et al.'s guided filter on [T, H, W]."""
    mean_g = _box_filter(guide_gray, radius)
    mean_s = _box_filter(src, radius)
    corr_g = _box_filter(guide_gray * guide_gray, radius)
    corr_gs = _box_filter(guide_gray * src, radius)
    var_g = corr_g - mean_g * mean_g
    cov_gs = corr_gs - mean_g * mean_s
    a = cov_gs / (var_g + eps)
    b = mean_s - a * mean_g
    return _box_filter(a, radius) * guide_gray + _box_filter(b, radius)


def _max_pool3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]


def edge_guided_alpha_upscale(
    alpha_in: torch.Tensor,  # [T, H_in, W_in] in [0, 1]
    rgb_up01: torch.Tensor,  # [T, H_out, W_out, 3] in [0, 1]
    is_binary_mask: bool,
) -> torch.Tensor:
    """[T, H_out, W_out] alpha in [0, 1]. ``is_binary_mask`` (the caller's
    decision from the input's statistics) picks the edge-snapping branch."""
    _, h_out, w_out, _ = rgb_up01.shape
    alpha_up = resize_video(alpha_in.float()[..., None], (h_out, w_out))[..., 0].clamp(0.0, 1.0)
    guide = rgb_up01.float().mean(dim=-1)
    if not is_binary_mask:
        return guided_filter(guide, alpha_up, radius=3, eps=0.002).clamp(0.0, 1.0)

    edges = sobel_edges(rgb_up01)
    refined = guided_filter(guide, alpha_up, radius=2, eps=0.002)
    transition = _max_pool3(edges)
    binary = (refined > 0.5).float()
    contrast = torch.sigmoid((refined - 0.5) * 12.0)
    edge_strength = (edges / 0.25).clamp(0.0, 1.0)
    in_edges = refined * (1 - edge_strength) + contrast * edge_strength
    combined = torch.where(transition < 0.05, binary, in_edges)
    combined = torch.where(transition < 0.03, (combined > 0.5).float(), combined)
    snap = (combined > 0.3) & (combined < 0.7) & ~(edges > 0.15)
    return torch.where(snap, (combined > 0.5).float(), combined).clamp(0.0, 1.0)


@torch.inference_mode()
def upscale_alpha_batch(alpha: np.ndarray, rgb_hi01: np.ndarray, device) -> np.ndarray:
    """alpha [T, H_in, W_in, 1] and the upscaled RGB [T, H_out, W_out, 3] in
    [0, 1] (host) -> [T, H_out, W_out] alpha in [0, 1] (host), computed on
    ``device``. A mask whose values sit below 0.1 or above 0.9 in more than
    95% of the pixels is treated as binary."""
    a = np.asarray(alpha, np.float32)[..., 0]
    is_binary = float(((a < 0.1) | (a > 0.9)).mean()) > 0.95
    out = edge_guided_alpha_upscale(torch.from_numpy(a).to(device),
                                    torch.from_numpy(np.ascontiguousarray(rgb_hi01, np.float32)).to(device), is_binary)
    return out.cpu().numpy()
