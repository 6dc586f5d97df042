"""Inference runner: the port's modules, the text embedding and the per-batch
stages (counterpart of seedvr2_tpu/pipeline/runner.py).

``fused_batch`` is the JAX package's ``_make_fused_fn`` chain, run eagerly:
to_f01 -> pipeline_transform -> VAE encode -> one Euler step of the NaDiT
-> VAE decode -> trim, colour fix, packed pixels (``finalize_batch``). The
4-phase path (pipeline/phases.py) calls the same stages one phase at a
time: ``vae_encode``, ``upscale``, ``vae_decode``, ``finalize_batch``. The
VAE stages read the tile settings of the config; on the 4-phase path they
run under the out-of-memory ladder (``_with_oom_fallback``): after a
torch.cuda.OutOfMemoryError they retry tiled, then with smaller tiles, and
a decode last of all host-staged. ``fused_batch`` runs the VAE without the
ladder, as the JAX package's fused program does: its OOM propagates to
phases.generate, which reruns the clip on the 4-phase path. With
``output_pixfmt="yuv420"`` ``fused_batch`` returns the sink's planes
(ops/yuv.py) instead of RGB codes. Each stage of ``fused_batch`` is a
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
import gc
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import PipelineConfig
from ..models.dit.nadit import NaDiT, build_attn_plans, device_plans
from ..models.vae import tiling
from ..models.vae.model import VAE
from ..ops import color as color_ops
from ..ops.resize import pipeline_transform, side_resize_dims, to_f01
from ..ops.yuv import PlanarYUV420, is_planar, rgb01_to_yuv420
from ..parallel.mesh import Mesh
from ..parallel.sp import sharded_dit
from ..utils.debug import Debug
from ..utils.transfer import to_device
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
        debug: Optional[Debug] = None,  # the run log: the OOM ladder's rungs go there
    ):
        check_supported(cfg)
        self.cfg = cfg
        self.dit = dit
        self.vae = vae
        self.mesh = mesh
        self.debug = debug or Debug()
        self.device = torch.device(device) if device is not None else next(dit.buffers()).device
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.text_pos = torch.as_tensor(np.asarray(text_pos, np.float32), device=self.device)[None]
        self.text_neg = (None if text_neg is None
                         else torch.as_tensor(np.asarray(text_neg, np.float32), device=self.device)[None])
        self._plans: Dict[Tuple, tuple] = {}
        self._disable_chunked = False  # set by phases.generate after the chunk route ran out of memory

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
        """Conditioning channels [cond latent | mask] of a [B, t, h, w, C]
        latent. Tasks: 'sr' (every frame conditioned on latent_blur, the
        upscaler's), 'i2v' (the first frame), 'v2v' (the first two), 't2v'
        (none); for i2v / v2v pass the clean latent as ``latent_blur``."""
        mask0 = torch.zeros(noise.shape[:-1] + (1,), dtype=noise.dtype, device=noise.device)
        if task == "sr":
            return torch.cat([latent_blur, mask0 + 1.0], dim=-1)
        if task == "t2v":
            return torch.cat([torch.zeros_like(noise), mask0], dim=-1)
        if task in ("i2v", "v2v"):
            n = 1 if task == "i2v" else 2
            keep = (torch.arange(noise.shape[1], device=noise.device) < n).to(noise.dtype).reshape(1, -1, 1, 1, 1)
            return torch.cat([latent_blur * keep, mask0 + keep], dim=-1)
        raise NotImplementedError(task)

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

    def _encode(self, video: torch.Tensor, tiled: bool, tile_size, tile_overlap, tile_parallel: bool = True):
        return tiling.vae_encode(
            self.vae, video, tiled=tiled, tile_size=tile_size, tile_overlap=tile_overlap,
            tile_batch=self.cfg.encode_tile_batch, shard=self._tile_parallel(video.shape[0], tile_parallel),
        )

    def _decode(self, latent: torch.Tensor, tiled: bool, tile_size, tile_overlap, tile_parallel: bool = True):
        return tiling.vae_decode(
            self.vae, latent, tiled=tiled, tile_size=tile_size, tile_overlap=tile_overlap,
            tile_batch=self.cfg.decode_tile_batch, shard=self._tile_parallel(latent.shape[0], tile_parallel),
        )

    @torch.inference_mode()
    def vae_encode(self, video: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] in [-1, 1] -> scaled latent, tiled as cfg says,
        under the OOM ladder."""
        c = self.cfg
        return self._with_oom_fallback("encode", lambda t, ts, to: self._encode(video, t, ts, to), c.encode_tiled,
                                       c.encode_tile_size, c.encode_tile_overlap)

    @torch.inference_mode()
    def vae_decode(self, latent: torch.Tensor) -> torch.Tensor:
        """Scaled latent -> [B, T, H, W, 3] in [-1, 1] on the latent's
        device, tiled as cfg says, under the OOM ladder (whose last rung
        returns fp32)."""
        c, vc = self.cfg, self.cfg.vae

        def staged(ts, to):
            z = latent / vc.scaling_factor + vc.shifting_factor
            return tiling.tiled_decode_staged(self.vae, z, ts, to).to(latent.device)

        return self._with_oom_fallback("decode", lambda t, ts, to: self._decode(latent, t, ts, to), c.decode_tiled,
                                       c.decode_tile_size, c.decode_tile_overlap, staged_fn=staged)

    def _with_oom_fallback(self, tag: str, fn, tiled: bool, tile_size, tile_overlap, staged_fn=None):
        """The JAX runner's ladder on torch.cuda.OutOfMemoryError (and on
        nothing else): untiled -> tiled at 1024/128 px -> the tile halved
        (overlap halved, at least 32 px) while it is above 256 px -> for a
        decode, ``staged_fn`` at the last tile (host-staged accumulation);
        past the last rung the error propagates. Every rung is logged with
        force=True.

        The caching allocator raises at the allocation, synchronously, so
        an OOM surfaces inside ``fn``: the JAX runner's completion fetch
        and its set of shapes already validated (there for asynchronous
        RESOURCE_EXHAUSTED) have no counterpart. The retry runs outside
        the ``except`` block, after a collection (should a reference cycle
        hold a failed frame) and empty_cache: inside it, the traceback
        still holds the failed attempt's frames and their activations."""
        while True:
            try:
                return fn(tiled, tile_size, tile_overlap)
            except torch.cuda.OutOfMemoryError:
                if tiled and tile_size[0] <= 256 and staged_fn is None:
                    raise
            if self.device.type == "cuda":
                gc.collect()
                torch.cuda.empty_cache()
            if not tiled:
                tiled, tile_size, tile_overlap = True, (1024, 1024), (128, 128)
            elif tile_size[0] > 256:
                tile_size = (tile_size[0] // 2, tile_size[1] // 2)
                tile_overlap = (max(32, tile_overlap[0] // 2),) * 2
            else:
                self.debug.log(f"HBM exhausted during VAE {tag} at the tile floor; falling back to host-staged tile "
                               "accumulation", category="memory", force=True)
                return staged_fn(tile_size, tile_overlap)
            self.debug.log(f"HBM exhausted during VAE {tag}; retrying with tiles {tile_size}",
                           category="memory", force=True)

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

    def _head(self, frames: torch.Tensor, seed: int, noise, input_noise: Optional[InputNoise],
              tile_parallel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The first three stages of the batch chain: transform (and input
        noise), VAE encode, one DiT step. Returns the upscaled latent and
        the clean transformed frames (fp32 [-1, 1], the colour fix's
        style)."""
        c = self.cfg
        with record_function("runner.transform"):
            tv = pipeline_transform(to_f01(frames), c.resolution, c.max_resolution)  # fp32 [-1, 1]
            video = tv if input_noise is None else input_noise.apply(tv)
        with record_function("runner.vae_encode"):
            latent = self._encode(video[None].to(self.compute_dtype), c.encode_tiled, c.encode_tile_size,
                                  c.encode_tile_overlap, tile_parallel)
        with record_function("runner.dit_step"):
            up = self.upscale(latent, seed, noise)
        return up, tv

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
        up, tv = self._head(frames, seed, noise, input_noise, tile_parallel)
        with record_function("runner.vae_decode"):
            dec = self._decode(up, c.decode_tiled, c.decode_tile_size, c.decode_tile_overlap, tile_parallel)
        with record_function("runner.color_pack"):
            return self.finalize_batch(dec, tv, tv.shape[0] if ori is None else ori, true_h, true_w, True, planes)

    # ----------------------- the streamed column chunks --------------------- #

    def _latent_thw(self, frames_shape) -> Tuple[int, int, int]:
        """The latent (t, h, w) of a batch of frames [T', h_in, w_in, 3]:
        resized, padded to /16, then the VAE's downsampling."""
        c = self.cfg
        th, tw = side_resize_dims(frames_shape[1], frames_shape[2], c.resolution, c.max_resolution)
        td, sf = c.vae.temporal_downsample_factor, c.vae.spatial_downsample_factor
        return (frames_shape[0] - 1) // td + 1, -(-th // 16) * 16 // sf, -(-tw // 16) * 16 // sf

    def supports_chunked(self, frames_shape, true_h: int, true_w: int) -> Optional[tiling.ColumnChunkPlan]:
        """The ColumnChunkPlan of a batch shape, or None where the streamed
        column-chunk route (fused_batch_chunks) would not give fused_batch's
        result or is not asked for: cfg.chunked_output "off", the route
        disabled after an out-of-memory error (``_disable_chunked``, set by
        phases.generate), an untiled decode, decode_tile_batch != 1, a mesh
        (its segments stream whole), or a colour method that is not
        spatially local (wavelet, none)."""
        c = self.cfg
        if (c.chunked_output == "off" or self._disable_chunked or not c.decode_tiled or c.decode_tile_batch != 1
                or self.mesh is not None or c.color_correction not in ("none", "wavelet")):
            return None
        _, h, w = self._latent_thw(frames_shape)
        halo = 32 if c.color_correction == "wavelet" else 0
        return tiling.column_chunk_plan(c.vae, h, w, c.decode_tile_size, c.decode_tile_overlap, true_h, true_w, halo)

    def _yuv_chunks_ok(self, plan: tiling.ColumnChunkPlan, true_h: int) -> bool:
        """Whether the chunks can be the sink's yuv420 planes: every chunk
        boundary even (the chroma is 2x2-subsampled, so chunks then share no
        chroma block) and an even frame height; otherwise they stay RGB
        codes."""
        return self.cfg.output_pixfmt == "yuv420" and true_h % 2 == 0 and all(e % 2 == 0 for e in plan.emit)

    @torch.inference_mode()
    def fused_batch_chunks(
        self,
        frames: torch.Tensor,  # as fused_batch takes them
        true_h: int,
        true_w: int,
        seed: int,
        plan: tiling.ColumnChunkPlan,
        noise=None,
        ori: Optional[int] = None,
        input_noise: Optional[InputNoise] = None,
    ) -> Iterator[Tuple[int, int, object]]:
        """The streamed sibling of fused_batch: the head (_head), then the
        decode one column tile at a time, left to right. Tile i is decoded,
        weighted into an fp32 (acc, cnt) strip that starts with the carry of
        tile i-1, divided and cast to the compute dtype, as tiled_decode
        blends; the columns that no later tile touches, with the colour
        halo, go through finalize_batch's chain (trim to ``ori`` frames,
        colour fix against the transformed frames, clamp, pack), and the
        chunk [lo, hi) of them is yielded as soon as its kernels are queued:
        int32 codes [ori, true_h, hi - lo, 3], or the sink's yuv420 planes
        where _yuv_chunks_ok. The caller can copy chunk i to the host while
        tile i+1 computes. The decode calls the VAE without the OOM ladder,
        as fused_batch does."""
        vc = self.cfg.vae
        up, tv = self._head(frames, seed, noise, input_noise)
        ori = tv.shape[0] if ori is None else ori
        planes = self._yuv_chunks_ok(plan, true_h)
        n = len(plan.cols)
        acc = cnt = None  # the carry: columns [emit[i-1] - halo, strip end of tile i-1)
        for i, col in enumerate(plan.cols):
            last = i == n - 1
            p_i = col * plan.sf
            strip_lo = 0 if i == 0 else plan.emit[i - 1] - plan.halo
            emit_lo, emit_hi = (0 if i == 0 else plan.emit[i - 1]), plan.emit[i]
            cin_lo = max(0, emit_lo - (plan.halo if i else 0))
            cin_hi = min(true_w, emit_hi + (0 if last else plan.halo))
            with record_function("runner.vae_decode"):
                z = up[:, :, :, col : col + plan.lt_w] / vc.scaling_factor + vc.shifting_factor
                dec = tiling.slicing_decode(self.vae, z)
                w = to_device(plan.tile_weights(i), self.device)[None, None, None, :, None]
                width = p_i + plan.tw - strip_lo
                strip = torch.zeros((1, dec.shape[1], plan.th, width, dec.shape[-1]), dtype=torch.float32,
                                    device=self.device)
                weight = torch.zeros((1, 1, plan.th, width, 1), dtype=torch.float32, device=self.device)
                if acc is not None:
                    strip[:, :, :, : acc.shape[3]] = acc
                    weight[:, :, :, : cnt.shape[3]] = cnt
                off = p_i - strip_lo
                strip[:, :, :, off : off + plan.tw] += dec.float() * w
                weight[:, :, :, off : off + plan.tw] += w
                del dec
                blended = (strip[:, :, :, cin_lo - strip_lo : cin_hi - strip_lo]
                           / weight[:, :, :, cin_lo - strip_lo : cin_hi - strip_lo].clamp_min(1e-6))
            with record_function("runner.color_pack"):
                out = self.finalize_batch(blended.to(self.compute_dtype), tv[:, :, cin_lo:cin_hi], ori, true_h,
                                          cin_hi - cin_lo, True, planes)
                a, b = emit_lo - cin_lo, emit_hi - cin_lo
                if is_planar(out):
                    chunk = PlanarYUV420(out.y[:, :, a:b], out.u[:, :, a // 2 : b // 2],
                                         out.v[:, :, a // 2 : b // 2], out.depth)
                else:
                    chunk = out[:, :, a:b]
            yield emit_lo, emit_hi, chunk
            if not last:
                klo = plan.emit[i] - plan.halo - strip_lo
                acc, cnt = strip[:, :, :, klo:], weight[:, :, :, klo:]

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
