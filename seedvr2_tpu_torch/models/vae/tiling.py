"""VAE encode/decode drivers, untiled (counterpart of the temporal-slicing
part of seedvr2_tpu/models/vae/tiling.py). A clip longer than
slicing_*_min_size runs as slices: the first in "init" mode, the rest in
"active" mode consuming the streaming carries — numerically a single pass.
Spatial tiling is not ported yet (ROADMAP.md queue 1, tiled VAE)."""

from __future__ import annotations

import torch

from ...config import VAEConfig
from .causal_conv import StreamCtx
from .model import VAE, posterior_mode


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


def vae_encode(vae: VAE, video: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, 3] in [-1, 1] -> scaled latent (mode(z) - shift) * scale."""
    cfg: VAEConfig = vae.cfg
    return (posterior_mode(slicing_encode(vae, video)) - cfg.shifting_factor) * cfg.scaling_factor


def vae_decode(vae: VAE, latent: torch.Tensor) -> torch.Tensor:
    cfg: VAEConfig = vae.cfg
    return slicing_decode(vae, latent / cfg.scaling_factor + cfg.shifting_factor)
