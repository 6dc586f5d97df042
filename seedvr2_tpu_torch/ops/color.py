"""Colour correction (counterpart of seedvr2_tpu/ops/color.py): the five
methods wavelet, lab, hsv, wavelet_adaptive and adain. Inputs and outputs
are [-1, 1], channels-first [B, C, H, W]; the math runs in fp32.

The blur is the 3x3 [1 2 1]^2/16 kernel, dilated, with replicate padding,
written as nine shifted fp32 adds rather than a depthwise conv: exact
fp32 on every device (a cuDNN fp32 conv may run in TF32) and memory-bound
either way.

Histogram matching sorts (stable sorts, as jnp.sort/argsort are, so tied
values keep the JAX package's order) and scatters; the per-hue-bin matching
of hsv runs each bin as a fixed-size masked sort with invalid lanes pushed
to +inf, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_TAPS = ((0.0625, 0.125, 0.0625), (0.125, 0.25, 0.125), (0.0625, 0.125, 0.0625))

# ----------------------------- wavelet ------------------------------------- #


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


# ------------------------------- adain ------------------------------------- #


def adaptive_instance_normalization(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Channel mean/std transfer; std with Bessel's correction, eps 1e-5 on
    the variance."""
    c, s = content.float(), style.float()
    B, C = c.shape[:2]

    def stats(x):
        v = x.reshape(B, C, -1)
        n = v.shape[-1]
        mean = v.mean(-1)
        var = (v - mean[..., None]).square().mean(-1) * (n / max(n - 1, 1)) + 1e-5
        return mean[:, :, None, None], torch.sqrt(var)[:, :, None, None]

    cm, cs = stats(c)
    sm, ss = stats(s)
    return ((c - cm) / cs * ss + sm).to(content.dtype)


# --------------------------- colour space math ----------------------------- #

_RGB2XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)
_XYZ2RGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)
_WHITE = (0.95047, 1.0, 1.08883)
_EPS_LAB = 6.0 / 29.0
_KAPPA = (29.0 / 3.0) ** 3


def _mix(m, x: torch.Tensor) -> torch.Tensor:
    """[3, 3] constant matrix times the channels of [B, 3, H, W]."""
    return torch.einsum("ij,bjhw->bihw", torch.tensor(m, dtype=torch.float32, device=x.device), x)


def _per_channel(v, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=x.device)[None, :, None, None]


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [0, 1] -> LAB."""
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    xyz = _mix(_RGB2XYZ, linear) / _per_channel(_WHITE, rgb)
    f = torch.where(xyz > _EPS_LAB**3, xyz.clamp_min(0.0) ** (1.0 / 3.0), (xyz * _KAPPA + 16.0) / 116.0)
    L = f[:, 1] * 116.0 - 16.0
    a = (f[:, 0] - f[:, 1]) * 500.0
    b = (f[:, 1] - f[:, 2]) * 200.0
    return torch.stack([L, a, b], dim=1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    L, a, b = lab[:, 0], lab[:, 1], lab[:, 2]
    fy = (L + 16.0) / 116.0
    fx = a / 500.0 + fy
    fz = fy - b / 200.0

    def finv(f):
        return torch.where(f > _EPS_LAB, f**3, (f * 116.0 - 16.0) / _KAPPA)

    xyz = torch.stack([finv(fx), finv(fy), finv(fz)], dim=1) * _per_channel(_WHITE, lab)
    lin = _mix(_XYZ2RGB, xyz)
    rgb = torch.where(lin > 0.0031308, lin.clamp_min(0.0) ** (1.0 / 2.4) * 1.055 - 0.055, lin * 12.92)
    return rgb.clamp(0.0, 1.0)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [0, 1] -> HSV, hue in [0, 1)."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    maxc = rgb.max(dim=1).values
    minc = rgb.min(dim=1).values
    rng = maxc - minc
    some = rng > 1e-10
    safe = torch.where(some, rng, torch.ones_like(rng))
    h = torch.zeros_like(maxc)
    h = torch.where((maxc == r) & some, ((g - b) / safe) % 6.0, h)
    h = torch.where((maxc == g) & some, (b - r) / safe + 2.0, h)
    h = torch.where((maxc == b) & some, (r - g) / safe + 4.0, h)
    h = h / 6.0
    s = torch.where(maxc > 1e-10, rng / maxc.clamp_min(1e-10), torch.zeros_like(maxc))
    return torch.stack([h, s, maxc], dim=1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h = hsv[:, 0] * 6.0
    s, v = hsv[:, 1], hsv[:, 2]
    i = torch.floor(h).to(torch.int32) % 6
    f = h - torch.floor(h)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def select(*vals):  # jnp.select over i == 0 .. 5 (i always hits one)
        out = vals[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)], dim=1)


# --------------------------- histogram matching ---------------------------- #


def histogram_match(source: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """CDF-match the flattened source to the reference (any shapes); returns
    source's shape."""
    src = source.reshape(-1)
    ref = torch.sort(reference.reshape(-1), stable=True).values
    n, m = src.shape[0], ref.shape[0]
    order = torch.argsort(src, stable=True)
    if n == m:
        matched_sorted = ref
    else:
        q = torch.linspace(0.0, 1.0, n, device=src.device)
        matched_sorted = ref[(q * (m - 1)).to(torch.int32).clamp(0, m - 1).long()]
    out = torch.zeros_like(src)
    out[order] = matched_sorted
    return out.reshape(source.shape)


def masked_histogram_match(
    source: torch.Tensor,  # [N]
    src_mask: torch.Tensor,  # [N] bool
    reference: torch.Tensor,  # [M]
    ref_mask: torch.Tensor,  # [M] bool
    min_pixels: int = 100,
    base: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fixed-shape masked CDF matching: valid source values are ranked among
    themselves and mapped to the reference's masked quantiles (index =
    trunc(rank / (n - 1) * (m - 1))); invalid lanes, and every lane when
    either side has min_pixels or fewer valid values, keep ``base``
    (default: the source)."""
    if base is None:
        base = source
    n = src_mask.sum()
    m = ref_mask.sum()
    inf = torch.full_like(source, float("inf"))
    keyed = torch.where(src_mask, source, inf)
    src_sorted_vals, order = torch.sort(keyed, stable=True)
    ref_sorted = torch.sort(torch.where(ref_mask, reference, torch.full_like(reference, float("inf"))), stable=True).values
    ranks = torch.arange(source.shape[0], device=source.device)
    q = ranks / torch.clamp(n - 1, min=1)
    ref_idx = torch.minimum((q * (m - 1)).to(torch.int32).clamp_min(0), torch.clamp(m - 1, min=0)).long()
    matched_sorted = torch.where(ranks < n, ref_sorted[ref_idx], src_sorted_vals)
    scattered = torch.zeros_like(source)
    scattered[order] = matched_sorted
    enough = (n > min_pixels) & (m > min_pixels)
    return torch.where(src_mask & enough, scattered, base)


# --------------------------- composite methods ----------------------------- #


def lab_color_transfer(content: torch.Tensor, style: torch.Tensor, luminance_weight: float = 0.8) -> torch.Tensor:
    """Wavelet base + LAB a*/b* histogram matching + weighted-L blend."""
    base = wavelet_reconstruction(content, style).float()
    c01 = ((base + 1.0) * 0.5).clamp(0.0, 1.0)
    s01 = ((style.float() + 1.0) * 0.5).clamp(0.0, 1.0)
    clab, slab = rgb_to_lab(c01), rgb_to_lab(s01)
    a = histogram_match(clab[:, 1], slab[:, 1])
    b = histogram_match(clab[:, 2], slab[:, 2])
    if luminance_weight < 1.0:
        Lm = histogram_match(clab[:, 0], slab[:, 0])
        L = clab[:, 0] * luminance_weight + Lm * (1.0 - luminance_weight)
    else:
        L = clab[:, 0]
    rgb = lab_to_rgb(torch.stack([L, a, b], dim=1))
    return (rgb * 2.0 - 1.0).to(content.dtype)


def hsv_saturation_match(content: torch.Tensor, style: torch.Tensor, num_bins: int = 12) -> torch.Tensor:
    """Hue-conditional saturation matching: per hue bin (bin 0 wraps around
    to take the top bin's hues too), the content's saturation CDF-matched to
    the style's, each bin from the original saturation."""
    c01 = ((content.float() + 1.0) * 0.5).clamp(0.0, 1.0)
    s01 = ((style.float() + 1.0) * 0.5).clamp(0.0, 1.0)
    chsv, shsv = rgb_to_hsv(c01), rgb_to_hsv(s01)
    ch, cs = chsv[:, 0].reshape(-1), chsv[:, 1].reshape(-1)
    sh, ss = shsv[:, 0].reshape(-1), shsv[:, 1].reshape(-1)
    matched = cs
    bw = 1.0 / num_bins
    for b in range(num_bins):
        lo, hi = b * bw, (b + 1) * bw
        if b == 0:
            cm = ((ch >= 0) & (ch < hi)) | (ch >= 1.0 - bw)
            sm = ((sh >= 0) & (sh < hi)) | (sh >= 1.0 - bw)
        else:
            cm = (ch >= lo) & (ch < hi)
            sm = (sh >= lo) & (sh < hi)
        matched = masked_histogram_match(cs, cm, ss, sm, base=matched)
    rgb = hsv_to_rgb(torch.stack([chsv[:, 0], matched.reshape(chsv[:, 1].shape), chsv[:, 2]], dim=1))
    return (rgb.clamp(0.0, 1.0) * 2.0 - 1.0).to(content.dtype)


def _saturation_map(x: torch.Tensor) -> torch.Tensor:
    rgb = ((x.float() + 1.0) * 0.5).clamp(0.0, 1.0)
    maxc = rgb.max(dim=1, keepdim=True).values
    minc = rgb.min(dim=1, keepdim=True).values
    return torch.where(maxc > 1e-10, (maxc - minc) / maxc.clamp_min(1e-10), torch.zeros_like(maxc))


def wavelet_adaptive_color_correction(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Wavelet base + sigmoid-gated HSV correction in oversaturated regions."""
    c32, s32 = content.float(), style.float()
    wav = wavelet_reconstruction(c32, s32).float()
    hsv = hsv_saturation_match(c32, s32).float()
    c_sat, s_sat, w_sat = _saturation_map(c32), _saturation_map(s32), _saturation_map(wav)
    thresh, sharp = 0.15, 5.0
    blend = torch.sigmoid(sharp * (c_sat - s_sat - thresh))
    blend = (blend * ((w_sat - s_sat) > (thresh * 0.5)).float()).clamp(0.0, 1.0)
    return (wav * (1.0 - blend) + hsv * blend).to(content.dtype)


_METHODS = {
    "wavelet": wavelet_reconstruction,
    "lab": lab_color_transfer,
    "hsv": hsv_saturation_match,
    "wavelet_adaptive": wavelet_adaptive_color_correction,
    "adain": adaptive_instance_normalization,
}
SUPPORTED = tuple(_METHODS) + ("none",)


def apply_color_correction(method: str, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    if method == "none":
        return content
    if method not in _METHODS:
        raise ValueError(f"Unknown color correction: {method}")
    return _METHODS[method](content, style)
