"""Rectified-flow diffusion math (counterpart of
seedvr2_tpu/pipeline/diffusion.py): the lerp schedule x_t = A(t) x_0 +
B(t) x_T with A = 1 - t/T, B = t/T, trailing timesteps, the resolution
timestep shift, the Euler sampler and classifier-free guidance. The step
math runs in fp32 (t arrays are fp32)."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def expand_dims_right(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


def schedule_A(t, T: float):
    return 1.0 - t / T


def schedule_B(t, T: float):
    return t / T


def schedule_forward(x0: torch.Tensor, xT: torch.Tensor, t: torch.Tensor, T: float) -> torch.Tensor:
    t = expand_dims_right(t, x0.ndim)
    return schedule_A(t, T) * x0 + schedule_B(t, T) * xT


def schedule_snr(t, T: float):
    """Signal-to-noise ratio A(t)^2 / B(t)^2."""
    return (schedule_A(t, T) ** 2) / (schedule_B(t, T) ** 2)


def schedule_isnr(snr, T: float):
    """The timestep of a signal-to-noise ratio: T / (1 + sqrt(snr))."""
    return T / (1.0 + snr**0.5)


def convert_from_pred(pred: torch.Tensor, pred_type: str, x_t: torch.Tensor, t: torch.Tensor, T: float):
    """(pred_x0, pred_xT) from the model prediction."""
    t = expand_dims_right(t, x_t.ndim)
    A, B = schedule_A(t, T), schedule_B(t, T)
    if pred_type == "x_T":
        return (x_t - B * pred) / A, pred
    if pred_type == "x_0":
        return pred, (x_t - A * pred) / B
    if pred_type == "v_cos":
        return A * x_t - B * pred, A * pred + B * x_t
    if pred_type == "v_lerp":
        return (x_t - B * pred) / (A + B), (x_t + A * pred) / (A + B)
    raise NotImplementedError(pred_type)


def convert_to_pred(x_0: torch.Tensor, x_T: torch.Tensor, t: torch.Tensor, T: float, pred_type: str) -> torch.Tensor:
    """The model prediction of ``pred_type`` from (x_0, x_T): the inverse
    of convert_from_pred."""
    if pred_type == "x_T":
        return x_T
    if pred_type == "x_0":
        return x_0
    if pred_type == "v_cos":
        t = expand_dims_right(t, x_0.ndim)
        return schedule_A(t, T) * x_T - schedule_B(t, T) * x_0
    if pred_type == "v_lerp":
        return x_T - x_0
    raise NotImplementedError(pred_type)


def uniform_trailing_timesteps(steps: int, T: float = 1000.0, shift: float = 1.0) -> np.ndarray:
    t = np.arange(1.0, 0.0, -1.0 / steps)[:steps]
    t = shift * t / (1.0 + (shift - 1.0) * t)
    return (t * T).astype(np.float32)


def timestep_shift(t: torch.Tensor, shift: torch.Tensor, T: float) -> torch.Tensor:
    u = t / T
    return shift * u / (1.0 + (shift - 1.0) * u) * T


def timestep_transform(
    t: torch.Tensor,  # [b] in [0, T]
    latent_shapes: torch.Tensor,  # [b, 3] latent (t, h, w)
    T: float = 1000.0,
    temporal_downsample: int = 4,
    spatial_downsample: int = 8,
) -> torch.Tensor:
    """Resolution-dependent shift: images 256^2 -> 1.0 .. 1024^2 -> 3.2,
    videos 256^2*37 -> 1.0 .. 1280*720*145 -> 5.0 over pixel volume."""
    frames = (latent_shapes[:, 0] - 1) * temporal_downsample + 1
    area = (latent_shapes[:, 1] * spatial_downsample * latent_shapes[:, 2] * spatial_downsample).float()

    def lin(x1, y1, x2, y2, x):
        m = (y2 - y1) / (x2 - x1)
        return m * x + (y1 - m * x1)

    img_shift = lin(256.0 * 256, 1.0, 1024.0 * 1024, 3.2, area)
    vid_shift = lin(256.0 * 256 * 37, 1.0, 1280.0 * 720 * 145, 5.0, area * frames.float())
    return timestep_shift(t, torch.where(frames > 1, vid_shift, img_shift), T)


def euler_step_to(pred, x_t, t, s, T: float, pred_type: str) -> torch.Tensor:
    """Step x_t -> x_s, endpoints clamped."""
    x_0, x_T = convert_from_pred(pred, pred_type, x_t, t, T)
    s_exp = expand_dims_right(s, x_t.ndim)
    x_s = schedule_forward(x_0, x_T, s.clamp(0.0, T), T)
    x_s = torch.where(s_exp >= 0, x_s, x_0)
    return torch.where(s_exp <= T, x_s, x_T)


def euler_sample(
    x: torch.Tensor,
    f: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor],
    timesteps: Sequence[float],
    T: float,
    pred_type: str,
) -> torch.Tensor:
    """Euler solve over a static timestep list ending at s = 0."""
    ts = list(timesteps) + [0.0]
    for i, (t, s) in enumerate(zip(ts[:-1], ts[1:])):
        t_arr = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        s_arr = torch.full((x.shape[0],), float(s), dtype=torch.float32, device=x.device)
        pred = f(x, t_arr, i)
        x = euler_step_to(pred, x, t_arr, s_arr, T, pred_type)
    return x


def classifier_free_guidance(pos, neg, scale: float, rescale: float = 0.0):
    cfg = neg + scale * (pos - neg)
    if rescale != 0.0:
        dims = tuple(range(1, pos.ndim))
        factor = pos.std(dim=dims, keepdim=True, correction=0) / cfg.std(dim=dims, keepdim=True, correction=0)
        cfg = cfg * (rescale * factor + (1.0 - rescale))
    return cfg


def cfg_dispatch(pos_fn, neg_fn, scale: float, rescale: float = 0.0):
    """Skip the negative branch entirely at scale 1."""
    if scale == 1.0:
        return pos_fn()
    return classifier_free_guidance(pos_fn(), neg_fn(), scale, rescale)
