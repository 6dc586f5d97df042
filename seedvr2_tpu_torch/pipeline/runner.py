"""Inference runner: the port's modules, the text embedding and the per-batch
stages (counterpart of seedvr2_tpu/pipeline/runner.py).

``fused_batch`` is the JAX package's ``_make_fused_fn`` chain, run eagerly:
to_f01 -> pipeline_transform -> VAE encode -> one Euler step of the NaDiT
-> VAE decode -> trim, colour fix, packed pixels (``finalize_batch``). The
4-phase path (pipeline/phases.py) calls the same stages one phase at a
time: ``vae_encode``, ``upscale``, ``vae_decode``, ``finalize_batch``. The
VAE stages read the tile settings of the config (the OOM ladder of the JAX
runner, which turns tiling on after RESOURCE_EXHAUSTED, is not ported: a
torch.cuda.OutOfMemoryError propagates). With ``output_pixfmt="yuv420"``
``fused_batch`` returns the sink's planes (ops/yuv.py) instead of RGB
codes. Each stage of ``fused_batch`` is a
``torch.profiler.record_function`` range ("runner.<stage>"), read by
profile_batch.py; without a running profiler a range is one small host call.

With a ``mesh`` (parallel/mesh.py) the runner is one rank of a multi-rank
job: the DiT step runs under ``sharded_dit`` over the mesh's seq and
tensor axes (the DiT must be split over the same tensor axis:
parallel/sharding.py), and a tiled VAE encode or decode of one clip splits
its tiles over every rank of the mesh (``_tile_parallel``), except inside
``fused_segment``, where each data rank holds its own segment.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import PipelineConfig
from ..models.dit.nadit import NaDiT, build_attn_plans, device_plans
from ..models.vae import tiling
from ..models.vae.model import VAE
from ..ops import color as color_ops
from ..ops.resize import pipeline_transform, to_f01
from ..ops.yuv import rgb01_to_yuv420
from ..parallel.mesh import Mesh
from ..parallel.sp import sharded_dit
from . import diffusion as dm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def check_supported(cfg: PipelineConfig) -> None:
    """Raise for a setting the pipeline does not know."""
    if cfg.color_correction not in color_ops.SUPPORTED:
        raise ValueError(f"Unknown color correction: {cfg.color_correction}")
    if cfg.output_pixfmt not in ("rgb", "yuv420"):
        raise ValueError(f"Unknown output_pixfmt: {cfg.output_pixfmt}")


class Draws(NamedTuple):
    """Random draws handed in instead of the generators' (torch's draws
    differ from JAX's threefry, so the tests hand in the JAX package's).
    A field left None is drawn as usual."""

    dit: Optional[torch.Tensor] = None  # [t, h, w, C]: the step's base noise
    latent: Optional[torch.Tensor] = None  # [t, h, w, C]: the second draw of the latent noise augmentation
    inputs: Optional[Sequence[torch.Tensor]] = None  # one [T', H', W', 3] unit-normal draw a batch, in batch order


def as_draws(noise) -> Draws:
    """``noise`` as the pipeline takes it: None, a Draws, or a tensor (the
    step's base noise alone)."""
    if noise is None:
        return Draws()
    return noise if isinstance(noise, Draws) else Draws(dit=noise)


class InputNoise:
    """The input noise augmentation of one run (cfg.input_noise_scale):
    each batch's transformed frames tv become tv (1 - s/2) + (tv + 0.05 z)
    s/2 with a unit-normal z of tv's shape, the VAE encodes them, and the
    colour fix still reads the clean tv. The z are drawn one a batch, in
    batch order, from a generator seeded with seed + 2_000_000 (the JAX
    package's "input_noise" key), or taken from ``given``. A multi-rank run
    draws the same z on every rank: one draw a clip, broadcast over the
    segments, as in the JAX package."""

    def __init__(self, cfg: PipelineConfig, device, given: Optional[Sequence[torch.Tensor]] = None):
        self.scale = cfg.input_noise_scale
        self.seed = cfg.seed + 2_000_000
        self.device = torch.device(device)
        self.given = given
        self.gen: Optional[torch.Generator] = None
        self.batch = 0

    def apply(self, tv: torch.Tensor) -> torch.Tensor:
        if self.scale <= 0:
            return tv
        if self.given is not None:
            z = self.given[self.batch].to(device=tv.device, dtype=tv.dtype)
            if z.shape != tv.shape:
                raise ValueError(f"input noise shape {tuple(z.shape)} != frames {tuple(tv.shape)}")
        else:
            if self.gen is None:
                self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
            z = torch.randn(tv.shape, generator=self.gen, device=self.device, dtype=tv.dtype)
        self.batch += 1
        blend = self.scale * 0.5
        return tv * (1 - blend) + (tv + z * 0.05) * blend


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
        mesh: Optional[Mesh] = None,
        text_neg=None,  # [Lt', txt_in_dim]: the negative prompt, read when cfg_scale != 1
    ):
        check_supported(cfg)
        self.cfg = cfg
        self.dit = dit
        self.vae = vae
        self.mesh = mesh
        self.device = torch.device(device) if device is not None else next(dit.buffers()).device
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.text_pos = torch.as_tensor(np.asarray(text_pos, np.float32), device=self.device)[None]
        self.text_neg = (None if text_neg is None
                         else torch.as_tensor(np.asarray(text_neg, np.float32), device=self.device)[None])
        self._plans: Dict[Tuple, tuple] = {}

    def with_config(self, cfg: PipelineConfig) -> "Runner":
        """A runner for another config over the same modules, text and
        device (settings such as noise, colour, tiling or the output
        format change; the DiT, the VAE and the compute dtype may not)."""
        if (cfg.dit, cfg.vae, cfg.compute_dtype) != (self.cfg.dit, self.cfg.vae, self.cfg.compute_dtype):
            raise ValueError("with_config: the DiT, VAE and compute dtype of a runner are fixed")
        check_supported(cfg)
        other = copy.copy(self)
        other.cfg = cfg
        return other

    def _device_plans(self, thw: Tuple[int, int, int], txt_len: int):
        """Window plans and rope tables of a latent shape and text length,
        built once."""
        key = (thw, txt_len)
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

    # ------------------------------- VAE ----------------------------------- #

    def _tile_parallel(self, batch_dim: int, tile_parallel: bool = True) -> Optional[tiling.TileShard]:
        """The tiles of a one-clip (batch 1) encode or decode go to every
        rank of the mesh, whatever its axes (a tensor-sharded DiT's ranks
        still share the VAE work); None without a mesh of more than one
        rank, or where the ranks hold different clips (``tile_parallel``
        False: fused_segment)."""
        if self.mesh is None or batch_dim != 1 or not tile_parallel or self.mesh.size == 1:
            return None
        return tiling.TileShard(self.mesh.rank, self.mesh.size, self.mesh.world)

    @torch.inference_mode()
    def vae_encode(self, video: torch.Tensor, tile_parallel: bool = True) -> torch.Tensor:
        """[B, T, H, W, 3] in [-1, 1] -> scaled latent, tiled as cfg says."""
        c = self.cfg
        return tiling.vae_encode(
            self.vae, video, tiled=c.encode_tiled, tile_size=c.encode_tile_size,
            tile_overlap=c.encode_tile_overlap, tile_batch=c.encode_tile_batch,
            shard=self._tile_parallel(video.shape[0], tile_parallel),
        )

    @torch.inference_mode()
    def vae_decode(self, latent: torch.Tensor, tile_parallel: bool = True) -> torch.Tensor:
        c = self.cfg
        return tiling.vae_decode(
            self.vae, latent, tiled=c.decode_tiled, tile_size=c.decode_tile_size,
            tile_overlap=c.decode_tile_overlap, tile_batch=c.decode_tile_batch,
            shard=self._tile_parallel(latent.shape[0], tile_parallel),
        )

    # ------------------------------- DiT ----------------------------------- #

    def _dit_sharding_ctx(self):
        """The context of the DiT forward: ``sharded_dit`` over the mesh (a
        pure data mesh leaves the forward unsharded); nothing on one rank."""
        return contextlib.nullcontext() if self.mesh is None else sharded_dit(self.mesh)

    @torch.inference_mode()
    def upscale(self, latent: torch.Tensor, seed: int, noise=None) -> torch.Tensor:
        """One-step upscale of a scaled latent [B, t, h, w, C] (phase 2's
        per-batch step; the DiT comes back to the device first if
        ``phased_weights`` moved it off). The noise is one per-batch draw
        [t, h, w, C] broadcast over B, from a generator seeded with ``seed``
        for every batch (identical inputs give identical outputs whatever
        their batch position); with latent_noise_scale > 0 a second draw
        from it augments the conditioning latent. ``noise`` (a Draws, or
        the base noise alone) overrides the draws.

        cfg_scale != 1 runs the DiT a second time on the negative prompt
        and guides between the two (diffusion.cfg_dispatch)."""
        self.ensure_dit_resident()
        cfg = self.cfg
        dt = self.compute_dtype
        latent = latent.to(self.device)
        per = tuple(latent.shape[1:])
        draws = as_draws(noise)
        gen = None

        def draw(given):
            nonlocal gen
            if given is not None:
                if tuple(given.shape) != per:
                    raise ValueError(f"noise shape {tuple(given.shape)} != latent shape {per}")
                return given.to(device=self.device, dtype=dt)[None].expand(latent.shape)
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
            z = torch.randn(per, generator=gen, device=self.device, dtype=torch.float32)
            return z.to(dt)[None].expand(latent.shape)

        base_noise = draw(draws.dit)
        T = cfg.diffusion.schedule_T
        blur = latent.to(dt)
        if cfg.latent_noise_scale > 0:
            aug_noise = base_noise * 0.1 + draw(draws.latent) * 0.05
            t0 = torch.full((latent.shape[0],), T * cfg.latent_noise_scale, dtype=torch.float32, device=self.device)
            if cfg.diffusion.timestep_transform:
                shapes = torch.tensor([list(per[:3])] * latent.shape[0], device=self.device)
                t0 = dm.timestep_transform(t0, shapes, T, cfg.vae.temporal_downsample_factor,
                                           cfg.vae.spatial_downsample_factor)
            blur = dm.schedule_forward(blur, aug_noise, t0, T).to(dt)
        cond = self.get_condition(base_noise, blur)
        dplans = self._device_plans(per[:3], int(self.text_pos.shape[1]))
        txt = self.text_pos.to(dt)
        if cfg.diffusion.cfg_scale != 1.0:
            if self.text_neg is None:
                raise ValueError("cfg_scale != 1 requires the negative text embedding (Runner(text_neg=))")
            neg_plans = self._device_plans(per[:3], int(self.text_neg.shape[1]))
            neg_txt = self.text_neg.to(dt)

        def f(x_t, t_arr, i):
            vid = torch.cat([x_t.to(dt), cond], dim=-1)
            return dm.cfg_dispatch(
                lambda: self.dit(vid, txt, t_arr, dplans), lambda: self.dit(vid, neg_txt, t_arr, neg_plans),
                cfg.diffusion.cfg_scale, cfg.diffusion.cfg_rescale,
            )

        timesteps = dm.uniform_trailing_timesteps(cfg.diffusion.sampling_steps, T)
        with self._dit_sharding_ctx():
            out = dm.euler_sample(base_noise, f, list(timesteps), T, cfg.diffusion.prediction_type)
        return out.to(dt)

    # --------------------------- the batch chain --------------------------- #

    @torch.inference_mode()
    def fused_batch(
        self,
        frames: torch.Tensor,  # [T', h_in, w_in, 3] on the device: uint8, int32 16-bit codes, or float [0, 1]
        true_h: int,
        true_w: int,
        seed: int,
        noise=None,
        ori: Optional[int] = None,
        tile_parallel: bool = True,
        input_noise: Optional[InputNoise] = None,
        planes: bool = True,
    ):
        """The whole per-batch pipeline. ``frames`` may be planar yuv420
        codes (ops/yuv.py), converted on the device. Returns packed codes
        [ori, true_h, true_w, 3] int32 (cfg.output_bits wide) on the
        device, the temporal padding trimmed before the colour fix
        (``ori`` defaults to every frame); with cfg.output_pixfmt "yuv420"
        and ``planes`` the sink's planes instead (8- or 10-bit codes as
        output_bits is 8 or 16). ``input_noise`` augments the encoder's
        input (cfg.input_noise_scale)."""
        c = self.cfg
        with record_function("runner.transform"):
            tv = pipeline_transform(to_f01(frames), c.resolution, c.max_resolution)  # fp32 [-1, 1]
            video = tv if input_noise is None else input_noise.apply(tv)
        with record_function("runner.vae_encode"):
            latent = self.vae_encode(video[None].to(self.compute_dtype), tile_parallel)
        with record_function("runner.dit_step"):
            up = self.upscale(latent, seed, noise)
        with record_function("runner.vae_decode"):
            dec = self.vae_decode(up, tile_parallel)
        with record_function("runner.color_pack"):
            return self.finalize_batch(dec, tv, tv.shape[0] if ori is None else ori, true_h, true_w, True, planes)

    def fused_segment(
        self,
        frames: torch.Tensor,  # this data rank's batch of its own segment, as fused_batch takes it
        true_h: int,
        true_w: int,
        seed: int,
        noise=None,
        ori: Optional[int] = None,
        input_noise: Optional[InputNoise] = None,
    ) -> torch.Tensor:
        """One data rank's step of frame-parallel generation (the counterpart
        of the JAX runner's fused_segments, whose segment batch this rank's
        segment is one row of): fused_batch on this rank's segment, the DiT
        sharded over the mesh's seq and tensor axes, the VAE not split over
        ranks (they hold other segments). The DiT noise is the batch's one
        draw from ``seed``, the same in every segment, as in the JAX
        package, and so is the input noise's (``input_noise``, one draw a
        clip). Returns packed RGB codes on the device (never planes: the
        segments are blended on rank 0)."""
        return self.fused_batch(frames, true_h, true_w, seed, noise, ori, tile_parallel=False,
                                input_noise=input_noise, planes=False)

    @torch.inference_mode()
    def finalize_batch(
        self,
        decoded: torch.Tensor,  # [1, T, H, W, 3] in [-1, 1] on the device
        ref,  # [T', h, w, 3]: raw frames (uint8 / int32 codes / float16 [0, 1]), or transformed when ref_transformed
        ori: int,
        true_h: int,
        true_w: int,
        ref_transformed: bool = False,
        planes: bool = False,
    ):
        """Trim to ``ori`` frames and the true size, colour-fix against the
        (transformed) reference, normalise and pack: [ori, true_h, true_w, 3]
        int32 codes on the device, or with ``planes`` and
        cfg.output_pixfmt "yuv420" the planar codes of ops/yuv.py (true_h
        and true_w are even: ops/resize.py:true_target_dims). Trimming first
        keeps the methods whose statistics span frames (lab, hsv,
        wavelet_adaptive, adain) free of the temporal padding."""
        c = self.cfg
        x = decoded[0, :ori, :true_h, :true_w].float()
        if ref is not None and c.color_correction != "none":
            if ref_transformed:
                style = ref.float()[:ori, :true_h, :true_w]
            else:
                style = pipeline_transform(to_f01(ref), c.resolution, c.max_resolution)[:ori, :true_h, :true_w]
            x = color_ops.apply_color_correction(
                c.color_correction, x.permute(0, 3, 1, 2), style.permute(0, 3, 1, 2)
            ).permute(0, 2, 3, 1)
        out01 = (x * 0.5 + 0.5).clamp(0.0, 1.0)
        if planes and c.output_pixfmt == "yuv420" and true_h % 2 == 0 and true_w % 2 == 0:
            return rgb01_to_yuv420(out01, 8 if c.output_bits == 8 else 10)
        return pack_frames(out01, c.output_bits)

    # ------------------------- phased weight residency ---------------------- #

    def weight_bytes(self) -> int:
        """Bytes of the DiT and VAE buffers: the resident weights that the run
        budget (phases._run_budget) subtracts from the device memory."""
        return sum(b.numel() * b.element_size() for m in (self.dit, self.vae) for b in m.buffers())

    def ensure_dit_resident(self) -> None:
        """Move the DiT back to the device after release_dit."""
        if next(self.dit.buffers()).device != self.device:
            self.dit.to(self.device)

    def release_dit(self) -> None:
        """With cfg.phased_weights, move the DiT's weights to host memory
        between phase 2 and the next run's phase 2, freeing device memory
        for the decode (the reference's phase-wise offload). No-op
        otherwise."""
        if self.cfg.phased_weights:
            self.dit.to("cpu")
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
