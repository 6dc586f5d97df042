"""End-to-end generation (counterpart of seedvr2_tpu/pipeline/phases.py).

Two routes, chosen as the JAX package's ``generate`` chooses them:

- the fused per-batch path (``generate_streaming`` -> Runner.fused_batch),
  for temporal_overlap 0, no prepended frames, fused_pipeline != "off",
  no phased_weights and tensor_offload != "always";
- the 4-phase path otherwise: encode every batch, upscale every batch,
  decode every batch, post-process every batch. Batch/overlap math, 4n+1
  padding, Hann blending of the overlap, per-batch seeding and
  trim-then-assemble are the JAX package's. Between phases the latents stay
  on the device or go to host memory as the run budget (``_run_budget``)
  or ``tensor_offload`` says. RGBA frames take this path: their alpha
  skips the models and is upscaled in phase 4 against the upscaled RGB
  (pipeline/alpha.py). Each phase is a
  ``torch.profiler.record_function`` range ("phase.<name>"), read by
  profile_batch.py.

Planar yuv420 input (ops/yuv.py) uploads as raw planes on the fused path
and is converted to RGB once up front on the 4-phase path; with
``output_pixfmt="yuv420"`` the fused path returns the sink's planes.
Random draws: ``noise`` is a runner.Draws (or the DiT base noise alone)
whose fields replace the generators' draws.

Batches run one after another; overlapping batch i+1's compute with batch
i's device->host copy (pinned buffers, a copy stream) is later work, and so
is the OOM ladder: a torch.cuda.OutOfMemoryError propagates.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import PipelineConfig
from ..ops import color as color_ops
from ..ops.blending import blend_overlapping_frames
from ..ops.resize import pipeline_transform, to_f01, true_target_dims
from ..ops.yuv import is_planar, yuv420_to_rgb01_np
from . import batching
from .runner import InputNoise, Runner, as_draws, check_supported


def upload_frames(rgb: np.ndarray, device) -> torch.Tensor:
    """Host frames -> device at 1-2 bytes a channel where possible: uint8 as
    is, 16-bit codes as int32 (scaled on the device), floats as float16;
    planar yuv420 codes as raw planes (1.5 codes a pixel)."""
    if is_planar(rgb):
        return rgb.to_device(device)
    if rgb.dtype == np.uint8:
        t = torch.from_numpy(np.ascontiguousarray(rgb))
    elif rgb.dtype == np.uint16:
        t = torch.from_numpy(rgb.astype(np.int32))
    else:
        t = torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.float16))
    return t.to(device)


def _unpack(codes: np.ndarray, cfg: PipelineConfig) -> np.ndarray:
    return codes.astype(np.float32) / np.float32(255.0 if cfg.output_bits == 8 else 65535.0)


def _packed_dtype(cfg: PipelineConfig):
    return np.uint8 if cfg.output_bits == 8 else np.uint16


def generate_streaming(
    runner: Runner,
    images,  # [T, H, W, 3] frames, or PlanarYUV420
    cfg: PipelineConfig,
    packed: bool = False,
    noise=None,
):
    """The fused per-batch path (Runner.fused_batch). Where the runner packs
    the sink's yuv420 planes, a ``packed`` caller gets a PlanarYUV420 of the
    whole clip; any other caller gets RGB (planes converted on the host,
    batch by batch: each holds whole frames, so no chroma seam)."""
    total = len(images)
    true_h, true_w = true_target_dims(images.shape[1], images.shape[2], cfg.resolution, cfg.max_resolution)
    specs = batching.compute_batches(total, cfg.batch_size, 0, cfg.uniform_batch_size)
    inoise = InputNoise(cfg, runner.device, as_draws(noise).inputs)
    final = None  # allocated at the first batch: RGB frames, or planes
    write = 0
    for spec in specs:
        video = batching.prepare_batch(images, spec)
        fr = upload_frames(video if is_planar(video) else video[..., :3], runner.device)
        codes = runner.fused_batch(fr, true_h, true_w, cfg.seed, noise=noise, ori=spec.ori_length, input_noise=inoise)
        ori = spec.ori_length
        if is_planar(codes) and packed:
            host = codes.to_numpy()
            if final is None:
                final = host.tmap(lambda p: np.zeros((total,) + p.shape[1:], p.dtype))
            for dst, src in zip((final.y, final.u, final.v), (host.y, host.u, host.v)):
                dst[write : write + ori] = src
        else:
            if is_planar(codes):
                host = yuv420_to_rgb01_np(codes.to_numpy()).astype(np.float32)
            else:
                host = codes.cpu().numpy()
                host = host.astype(_packed_dtype(cfg)) if packed else _unpack(host, cfg)
            if final is None:
                final = np.zeros((total, true_h, true_w, 3), host.dtype)
            final[write : write + ori] = host
        write += ori
    return final[:write]


# --------------------------------------------------------------------------- #
# The 4-phase path
# --------------------------------------------------------------------------- #


def make_context(cfg: PipelineConfig) -> Dict[str, Any]:
    """The state the four phases hand on."""
    return {
        "cfg": cfg,
        "batches": None,
        "all_latents": [],
        "all_upscaled": [],
        "final_video": None,
        "decode_info": [],
        "true_dims": None,
        "total_frames": 0,
        "ref_device": {},
        "packed": False,
        "is_rgba": False,
        "all_alpha": [],
    }


def _transform_batch(cfg: PipelineConfig, rgb: np.ndarray, device) -> torch.Tensor:
    """[T, H, W, 3] host frames -> [T, H', W', 3] fp32 in [-1, 1] on the
    device (resize, pad to /16, normalise)."""
    return pipeline_transform(to_f01(upload_frames(rgb, device)), cfg.resolution, cfg.max_resolution)


def _to_host_if(offload: bool, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if offload else t


@torch.inference_mode()
def encode_all_batches(runner: Runner, ctx: Dict[str, Any], images: np.ndarray,
                       input_noise: Optional[InputNoise] = None) -> Dict[str, Any]:
    """Phase 1: prepend frames, batch math, transform and VAE-encode every
    batch; the transformed frames are stashed on the device as the colour
    reference when the run budget allows. RGBA frames leave their alpha on
    the host for phase 4. ``input_noise`` augments the encoder's input
    (cfg.input_noise_scale; the colour reference stays clean)."""
    cfg: PipelineConfig = ctx["cfg"]
    if cfg.prepend_frames > 0:
        images = batching.pad_temporal_reversed(images, cfg.prepend_frames, prepend=True)
    ctx["total_frames"] = len(images)
    ctx["input_images"] = images
    ctx["is_rgba"] = images.shape[-1] == 4
    ctx["true_dims"] = true_target_dims(images.shape[1], images.shape[2], cfg.resolution, cfg.max_resolution)
    overlap = batching.effective_overlap(cfg.batch_size, cfg.temporal_overlap)
    ctx["actual_overlap"] = overlap
    specs = batching.compute_batches(len(images), cfg.batch_size, overlap, cfg.uniform_batch_size)
    ctx["batches"] = specs
    ctx["all_latents"] = [None] * len(specs)
    ctx["all_alpha"] = [None] * len(specs)
    input_noise = input_noise or InputNoise(cfg, runner.device)
    with record_function("phase.encode"):
        for bi, spec in enumerate(specs):
            video = batching.prepare_batch(images, spec)
            if ctx["is_rgba"]:
                ctx["all_alpha"][bi] = video[..., 3:]
            tv = _transform_batch(cfg, video[..., :3], runner.device)
            if _stash_color_ref(cfg, ctx, runner):
                ctx["ref_device"][bi] = tv
            latent = runner.vae_encode(input_noise.apply(tv)[None].to(runner.compute_dtype))
            ctx["all_latents"][bi] = _to_host_if(_offload(cfg, ctx, runner), latent[0])
    return ctx


@torch.inference_mode()
def upscale_all_batches(runner: Runner, ctx: Dict[str, Any], noise=None) -> Dict[str, Any]:
    """Phase 2: one DiT step per batch, each seeded alike (outputs do not
    depend on batch position); ``noise`` replaces every batch's draw. With
    phased_weights the DiT then leaves the device for the decode."""
    cfg: PipelineConfig = ctx["cfg"]
    n = len(ctx["all_latents"])
    ctx["all_upscaled"] = [None] * n
    with record_function("phase.upscale"):
        for bi in range(n):
            up = runner.upscale(ctx["all_latents"][bi][None], cfg.seed, noise)
            ctx["all_upscaled"][bi] = _to_host_if(_offload(cfg, ctx, runner), up[0])
            ctx["all_latents"][bi] = None
    runner.release_dit()
    return ctx


@torch.inference_mode()
def decode_all_batches(runner: Runner, ctx: Dict[str, Any]) -> Dict[str, Any]:
    """Phase 3: decode every batch, trim its temporal and spatial padding,
    Hann-blend the overlap with the previous batch's tail, and write it into
    one host float32 video in [-1, 1] (with a fourth channel for phase 4's
    alpha when the input is RGBA)."""
    true_h, true_w = ctx["true_dims"]
    final = np.zeros((ctx["total_frames"], true_h, true_w, 4 if ctx["is_rgba"] else 3), np.float32)
    overlap = ctx["actual_overlap"]
    specs = ctx["batches"]
    write = 0
    ctx["decode_info"] = []
    with record_function("phase.decode"):
        for bi, up in enumerate(ctx["all_upscaled"]):
            dec = runner.vae_decode(up.to(runner.device)[None])[0]
            ori = specs[bi].ori_length
            sample = dec[:ori, :true_h, :true_w].float().cpu()
            if bi > 0 and 0 < overlap < sample.shape[0] and write >= overlap:
                prev = torch.from_numpy(final[write - overlap : write, ..., :3])
                blended = blend_overlapping_frames(prev, sample[:overlap], overlap)
                final[write - overlap : write, ..., :3] = blended.numpy()
                sample = sample[overlap:]
            t = sample.shape[0]
            final[write : write + t, ..., :3] = sample.numpy()
            ctx["decode_info"].append((write, write + t, bi, ori))
            write += t
            ctx["all_upscaled"][bi] = None
    ctx["final_video"] = final[:write]
    return ctx


@torch.inference_mode()
def postprocess_all_batches(runner: Runner, ctx: Dict[str, Any]) -> Dict[str, Any]:
    """Phase 4: per batch, the colour fix against the transformed input
    (the phase-1 stash, or transformed again), trimmed like the output;
    [-1, 1] -> [0, 1]; an RGBA input's alpha upscaled against the result
    (pipeline/alpha.py); the prepended frames dropped."""
    cfg: PipelineConfig = ctx["cfg"]
    final = ctx["final_video"]
    specs = ctx["batches"]
    true_h, true_w = ctx["true_dims"]
    with record_function("phase.postprocess"):
        for ws, we, bi, ori in ctx["decode_info"]:
            out = final[ws:we, ..., :3]
            skip = ori - (we - ws)  # overlap frames dropped from the batch head
            if cfg.color_correction != "none":
                ref = ctx["ref_device"].pop(bi, None)
                if ref is None:
                    video = batching.prepare_batch(ctx["input_images"], specs[bi])
                    ref = _transform_batch(cfg, video[..., :3], runner.device)
                style = ref[skip:ori, :true_h, :true_w].permute(0, 3, 1, 2)
                content = torch.from_numpy(out).to(runner.device).permute(0, 3, 1, 2)
                out = color_ops.apply_color_correction(cfg.color_correction, content, style).permute(0, 2, 3, 1).cpu().numpy()
            final[ws:we, ..., :3] = np.clip(out / 2.0 + 0.5, 0.0, 1.0)
            if ctx["is_rgba"]:
                from .alpha import upscale_alpha_batch

                final[ws:we, ..., 3] = upscale_alpha_batch(ctx["all_alpha"][bi][skip:ori], final[ws:we, ..., :3],
                                                           runner.device)
    if cfg.prepend_frames > 0:
        final = final[cfg.prepend_frames :]
    ctx["final_video"] = final
    return ctx


@torch.inference_mode()
def decode_and_postprocess_fused(runner: Runner, ctx: Dict[str, Any]) -> Dict[str, Any]:
    """Phases 3 and 4 per batch when no batch overlaps another and nothing
    was prepended: decode, then Runner.finalize_batch (trim, colour, pack)
    on the device; only the packed codes reach the host."""
    cfg: PipelineConfig = ctx["cfg"]
    true_h, true_w = ctx["true_dims"]
    specs = ctx["batches"]
    packed = bool(ctx.get("packed"))
    final = np.zeros((ctx["total_frames"], true_h, true_w, 3), _packed_dtype(cfg) if packed else np.float32)
    write = 0
    with record_function("phase.decode"):
        for bi, up in enumerate(ctx["all_upscaled"]):
            dec = runner.vae_decode(up.to(runner.device)[None])
            ori = specs[bi].ori_length
            ref, transformed = None, False
            if cfg.color_correction != "none":
                ref = ctx["ref_device"].pop(bi, None)
                transformed = ref is not None
                if ref is None:
                    ref = upload_frames(batching.prepare_batch(ctx["input_images"], specs[bi])[..., :3], runner.device)
            host = runner.finalize_batch(dec, ref, ori, true_h, true_w, ref_transformed=transformed).cpu().numpy()
            final[write : write + ori] = host.astype(_packed_dtype(cfg)) if packed else _unpack(host, cfg)
            write += ori
            ctx["all_upscaled"][bi] = None
    ctx["final_video"] = final[:write]
    return ctx


def generate(
    runner: Runner,
    images,  # [T, H, W, 3|4]: float in [0, 1], uint8 or uint16; or PlanarYUV420
    cfg: Optional[PipelineConfig] = None,
    packed: bool = False,
    noise=None,
):
    """Frames THWC -> upscaled frames THWC: float32 in [0, 1], or with
    ``packed=True`` the uint16 / uint8 codes (cfg.output_bits) where the
    route packs on the device (the fused path, and the 4-phase path without
    overlap or prepended frames; the others, and RGBA, return float32, as
    in the JAX package). With cfg.output_pixfmt "yuv420" a ``packed``
    caller of the fused path gets a PlanarYUV420. ``noise``: a Draws (or
    the DiT base noise [t, h, w, C] alone) replacing the generators' draws
    (tests)."""
    cfg = cfg or runner.cfg
    check_supported(cfg)
    can_stream = (
        cfg.fused_pipeline != "off"
        and batching.effective_overlap(cfg.batch_size, cfg.temporal_overlap) == 0
        and images.shape[-1] == 3
        and cfg.prepend_frames == 0
        and not cfg.phased_weights
        and cfg.tensor_offload != "always"
        and len(images) > 0
    )
    if can_stream:
        return generate_streaming(runner, images, cfg, packed=packed, noise=noise)
    if is_planar(images):
        # the 4-phase path works on RGB frames on the host: convert once here
        images = yuv420_to_rgb01_np(images.to_numpy()).astype(np.float32)
    ctx = make_context(cfg)
    ctx["packed"] = packed
    encode_all_batches(runner, ctx, images, InputNoise(cfg, runner.device, as_draws(noise).inputs))
    upscale_all_batches(runner, ctx, noise)
    if ctx["actual_overlap"] == 0 and cfg.prepend_frames == 0 and not ctx["is_rgba"]:
        decode_and_postprocess_fused(runner, ctx)
    else:
        decode_all_batches(runner, ctx)
        postprocess_all_batches(runner, ctx)
    return ctx["final_video"]


# --------------------------------------------------------------------------- #
# The run budget
# --------------------------------------------------------------------------- #


def _phase_peak_bytes(cfg: PipelineConfig, th: int, tw: int) -> int:
    """Largest single-stage working set of the run, from the VAE
    architecture: the widest activation is the full-resolution
    block_out_channels[0] feature map of the decoder, bf16, doubled for
    producer and consumer; a tiled decode bounds it to a tile but adds the
    fp32 accumulators at full size. On top rides the decoded fp32 batch."""
    t_batch = cfg.batch_size + 1  # 4n+1-padded batch, worst case
    hp, wp = -(-th // 16) * 16, -(-tw // 16) * 16
    c0 = cfg.vae.block_out_channels[0]
    if cfg.decode_tiled:
        tile_h = min(cfg.decode_tile_size[0], hp)
        tile_w = min(cfg.decode_tile_size[1], wp)
        widest = t_batch * tile_h * tile_w * c0 * 2 * 2 * max(cfg.decode_tile_batch, 1)
        widest += t_batch * hp * wp * 4 * 4  # fp32 acc (3ch) + cnt (1ch)
    else:
        widest = t_batch * hp * wp * c0 * 2 * 2
    decoded_f32 = t_batch * hp * wp * 3 * 4
    return int(widest + decoded_f32)


def _hbm_bytes(device) -> int:
    """The card's total memory; 16 GiB (the JAX package's constant when the
    device reports no limit) for a CPU device, so that the two packages'
    budget decisions can be compared."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 16 << 30


def _run_budget(cfg: PipelineConfig, ctx: Dict[str, Any], runner=None) -> Dict[str, Any]:
    """One device-memory budget for the whole run, computed once: the free
    pool is the device memory less the resident weights less 5%; offload
    the latents to host when latents + peak exceed 75% of it; stash the
    colour reference on the device only when latents + stash + peak fit in
    75% and the run does not offload."""
    cached = ctx.get("_budget")
    if cached is None:
        th, tw = ctx["true_dims"]
        total = max(ctx["total_frames"], 1)
        hbm = _hbm_bytes(runner.device if runner is not None else "cpu")
        weights = runner.weight_bytes() if runner is not None else 0
        free = max(hbm - weights - int(0.05 * hbm), 1)
        lat_frames = total // 4 + 1  # 4x temporal compression, 4n+1 batches
        latents = 2 * lat_frames * (th // 8) * (tw // 8) * cfg.vae.latent_channels * 2
        n_batches = max(len(ctx["batches"] or ()), 1)
        stash = n_batches * (cfg.batch_size + 1) * th * tw * 3 * 4 if cfg.color_correction != "none" else 0
        peak = _phase_peak_bytes(cfg, th, tw)
        offload = (latents + peak) > 0.75 * free
        stash_ok = stash > 0 and not offload and (latents + stash + peak) < 0.75 * free
        cached = {"offload": offload, "stash": stash_ok, "latents_gib": latents / 2**30, "stash_gib": stash / 2**30,
                  "peak_gib": peak / 2**30, "free_gib": free / 2**30}
        ctx["_budget"] = cached
    return cached


def _stash_color_ref(cfg: PipelineConfig, ctx: Dict[str, Any], runner=None) -> bool:
    """Keep phase 1's transformed frames on the device as the colour
    reference of phases 3/4, when the run budget allows."""
    if cfg.color_correction == "none" or cfg.tensor_offload == "always":
        return False
    return _run_budget(cfg, ctx, runner)["stash"]


def _offload(cfg: PipelineConfig, ctx: Dict[str, Any], runner=None) -> bool:
    """Pull the latents to host memory between phases: always, never, or
    ("auto") as the run budget says."""
    if cfg.tensor_offload == "always":
        return True
    if cfg.tensor_offload == "never":
        return False
    return _run_budget(cfg, ctx, runner)["offload"]
