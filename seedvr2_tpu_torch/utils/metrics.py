"""Quality metrics on host frames: PSNR and SSIM in numpy (the port's copy
of seedvr2_tpu/utils/metrics.py; tests/test_torch_metrics.py holds the two
equal)."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB over all elements (inf when equal)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val**2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Valid-mode 2D filtering per channel over sliding windows."""
    from numpy.lib.stride_tricks import sliding_window_view

    kh, kw = kernel.shape
    win = sliding_window_view(img, (kh, kw), axis=(0, 1))
    return np.einsum("ijckl,kl->ijc", win, kernel)


def ssim(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004: 11x11 Gaussian window, sigma 1.5,
    K1 0.01, K2 0.03) of [H, W, C] or [H, W] images in [0, max_val]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    s_aa = _filter2(a * a, k) - mu_aa
    s_bb = _filter2(b * b, k) - mu_bb
    s_ab = _filter2(a * b, k) - mu_ab
    ssim_map = ((2 * mu_ab + c1) * (2 * s_ab + c2)) / ((mu_aa + mu_bb + c1) * (s_aa + s_bb + c2))
    return float(np.mean(ssim_map))


def video_psnr_ssim(a: np.ndarray, b: np.ndarray, max_val: float = 1.0):
    """(PSNR over the clip, mean per-frame SSIM) of [T, H, W, C] clips."""
    p = psnr(a, b, max_val)
    s = float(np.mean([ssim(a[t], b[t], max_val) for t in range(a.shape[0])]))
    return p, s
