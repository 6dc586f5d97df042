"""Inference runner: the port's modules, the text embedding and the per-batch
chain (counterpart of seedvr2_tpu/pipeline/runner.py, fused path).

``fused_batch`` is the JAX package's ``_make_fused_fn`` chain, run eagerly:
to_f01 -> pipeline_transform -> VAE encode -> one Euler step of the NaDiT
-> VAE decode -> colour fix -> packed pixels. Each stage is a
``torch.profiler.record_function`` range ("runner.<stage>"), read by
profile_batch.py; without a running profiler a range is one small host call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import PipelineConfig
from ..models.dit.nadit import NaDiT, build_attn_plans, device_plans
from ..models.vae.model import VAE
from ..models.vae.tiling import vae_decode, vae_encode
from ..ops import color as color_ops
from ..ops.resize import pipeline_transform, to_f01
from . import diffusion as dm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _not_ported(setting: str, item: str):
    return NotImplementedError(f"{setting} is not ported yet (ROADMAP.md queue 1: {item})")


def check_supported(cfg: PipelineConfig) -> None:
    """Raise for every setting off the ported path."""
    if cfg.encode_tiled or cfg.decode_tiled:
        raise _not_ported("tiled VAE encode/decode", "tiled VAE")
    if cfg.color_correction not in color_ops.SUPPORTED:
        raise _not_ported(f"color_correction={cfg.color_correction!r}", "the rest of the pipeline")
    if cfg.diffusion.cfg_scale != 1.0:
        raise _not_ported("cfg_scale != 1", "the rest of the pipeline")
    if cfg.output_pixfmt != "rgb":
        raise _not_ported(f"output_pixfmt={cfg.output_pixfmt!r}", "the rest of the pipeline")
    if cfg.prepend_frames > 0:
        raise _not_ported("prepend_frames > 0", "the rest of the pipeline")
    if cfg.input_noise_scale > 0 or cfg.latent_noise_scale > 0:
        raise _not_ported("input/latent noise augmentation", "the rest of the pipeline")
    if cfg.fused_pipeline == "off" or cfg.phased_weights or cfg.tensor_offload == "always":
        raise _not_ported("the 4-phase pipeline", "the rest of the pipeline")


def pack_frames(out01: torch.Tensor, bits: int) -> torch.Tensor:
    """[0, 1] -> integer codes (v / 255 or v / 65535), truncated like the
    JAX package's astype. Kept as int32 on the device; the host narrows."""
    return (out01 * (255.0 if bits == 8 else 65535.0) + 0.5).to(torch.int32)


class Runner:
    def __init__(
        self,
        cfg: PipelineConfig,
        dit: NaDiT,
        vae: VAE,
        text_pos,  # [Lt, txt_in_dim]
        device=None,
    ):
        check_supported(cfg)
        self.cfg = cfg
        self.dit = dit
        self.vae = vae
        self.device = torch.device(device) if device is not None else next(dit.buffers()).device
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.text_pos = torch.as_tensor(np.asarray(text_pos, np.float32), device=self.device)[None]
        self._plans: Dict[Tuple, tuple] = {}

    def _device_plans(self, thw: Tuple[int, int, int]):
        """Window plans and rope tables of a latent shape, built once."""
        key = (thw, int(self.text_pos.shape[1]))
        if key not in self._plans:
            pt, ph, pw = self.cfg.dit.patch_size
            patched = (thw[0] // pt, thw[1] // ph, thw[2] // pw)
            plans = build_attn_plans(self.cfg.dit, patched, key[1])
            self._plans[key] = device_plans(plans, self.cfg.dit.head_dim, self.device)
        return self._plans[key]

    @staticmethod
    def get_condition(noise: torch.Tensor, latent_blur: torch.Tensor, task: str = "sr") -> torch.Tensor:
        """Conditioning channels [cond latent | mask]; the upscaler uses 'sr'."""
        if task != "sr":
            raise NotImplementedError(task)
        return torch.cat([latent_blur, torch.ones_like(noise[..., :1])], dim=-1)

    def step(self, latent: torch.Tensor, seed: int, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One-step upscale of a scaled latent [B, t, h, w, C]. The noise is
        one per-batch draw [t, h, w, C] broadcast over B, from a generator
        seeded with ``seed`` for every batch (identical inputs give identical
        outputs whatever their batch position). torch's draws differ from
        JAX's threefry, so ``noise`` overrides the draw: the tests hand in
        the JAX package's."""
        cfg = self.cfg
        dt = self.compute_dtype
        per = tuple(latent.shape[1:])
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = torch.randn(per, generator=gen, device=self.device, dtype=torch.float32)
        elif tuple(noise.shape) != per:
            raise ValueError(f"noise shape {tuple(noise.shape)} != latent shape {per}")
        base_noise = noise.to(device=self.device, dtype=dt)[None].expand(latent.shape)
        cond = self.get_condition(base_noise, latent.to(dt))  # no latent noise: the blur is the latent
        T = cfg.diffusion.schedule_T
        dplans = self._device_plans(per[:3])
        txt = self.text_pos.to(dt)

        def f(x_t, t_arr, i):
            vid = torch.cat([x_t.to(dt), cond], dim=-1)
            return dm.cfg_dispatch(
                lambda: self.dit(vid, txt, t_arr, dplans), None, cfg.diffusion.cfg_scale, cfg.diffusion.cfg_rescale
            )

        timesteps = dm.uniform_trailing_timesteps(cfg.diffusion.sampling_steps, T)
        out = dm.euler_sample(base_noise, f, list(timesteps), T, cfg.diffusion.prediction_type)
        return out.to(dt)

    @torch.inference_mode()
    def fused_batch(
        self,
        frames: torch.Tensor,  # [T', h_in, w_in, 3] on the device: uint8, int32 16-bit codes, or float [0, 1]
        true_h: int,
        true_w: int,
        seed: int,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The whole per-batch pipeline. Returns packed codes [T', true_h,
        true_w, 3] int32 (cfg.output_bits wide) on the device; the caller
        trims temporal padding (the colour methods here are per pixel)."""
        c = self.cfg
        with record_function("runner.transform"):
            tv = pipeline_transform(to_f01(frames), c.resolution, c.max_resolution)  # fp32 [-1, 1]
        with record_function("runner.vae_encode"):
            latent = vae_encode(self.vae, tv[None].to(self.compute_dtype))
        with record_function("runner.dit_step"):
            up = self.step(latent, seed, noise)
        with record_function("runner.vae_decode"):
            dec = vae_decode(self.vae, up)
        with record_function("runner.color_pack"):
            x = dec[0, :, :true_h, :true_w].float()
            if c.color_correction != "none":
                style = tv[:, :true_h, :true_w]
                x = color_ops.apply_color_correction(
                    c.color_correction, x.permute(0, 3, 1, 2), style.permute(0, 3, 1, 2)
                ).permute(0, 2, 3, 1)
            return pack_frames((x * 0.5 + 0.5).clamp(0.0, 1.0), c.output_bits)
