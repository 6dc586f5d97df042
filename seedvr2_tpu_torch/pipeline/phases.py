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

Progress and interrupt, as in the JAX package: ``interrupt_fn`` is called
before every batch of every phase and may raise (nothing here catches what
it raises); ``progress_callback(cur, total, frames, phase_name)`` after
it, with the phase names "Phase 1: Encoding", "Phase 2: Upscaling",
"Phase 3: Decoding" and "Phase 4: Post-processing". The fused path reports
phases 1 and 2 once up front as (1, 1, 0, ...), phase 3 per batch and
phase 4 once at the end.

The fused path's output stream: a batch whose decode grid is one row of
column tiles (Runner.supports_chunked, cfg.chunked_output "auto") runs as
Runner.fused_batch_chunks, which yields each finished column chunk while
the next tile still computes; any other batch runs as one
Runner.fused_batch. Each chunk (or whole batch) is copied to pinned host
memory on a side copy stream as soon as its kernels are queued
(utils/transfer.py), and batch i is flushed (the copies waited for, the
codes unpacked or the planes converted on the host) only after batch
i+1's work has been queued, so that the copies and the host's unpack
overlap the next batch's compute. On a CPU runner the same code reads the
chunks where they lie.

Out of memory: where the chunk route raises torch.cuda.OutOfMemoryError,
``generate`` logs it, disables the route on the runner
(``_disable_chunked``) and reruns the clip with one fused_batch a batch;
where the fused path raises it, ``generate`` logs it and reruns the clip
on the 4-phase path, whose VAE calls run under the runner's ladder (tiled,
smaller tiles, host-staged decode).
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import PipelineConfig
from ..ops import color as color_ops
from ..ops.blending import blend_overlapping_frames
from ..ops.resize import pipeline_transform, to_f01, true_target_dims
from ..ops.yuv import PlanarYUV420, is_planar, yuv420_to_rgb01_np
from ..utils.debug import Debug
from ..utils.transfer import HostCopies, to_device
from . import batching
from .runner import InputNoise, Runner, as_draws, check_supported


def upload_frames(rgb: np.ndarray, device) -> torch.Tensor:
    """Host frames -> device at 1-2 bytes a channel where possible: uint8 as
    is, 16-bit codes as int32 (scaled on the device), floats as float16;
    planar yuv420 codes as raw planes (1.5 codes a pixel)."""
    if is_planar(rgb):
        return rgb.to_device(device)
    if rgb.dtype == np.uint16:
        return to_device(rgb.astype(np.int32), device)
    return to_device(rgb if rgb.dtype == np.uint8 else np.asarray(rgb, np.float16), device)


def _unpack(codes: np.ndarray, cfg: PipelineConfig) -> np.ndarray:
    return codes.astype(np.float32) / np.float32(255.0 if cfg.output_bits == 8 else 65535.0)


def _packed_dtype(cfg: PipelineConfig):
    return np.uint8 if cfg.output_bits == 8 else np.uint16


def _start_copy(copies: HostCopies, out):
    """The host copy of a chunk: codes, or a PlanarYUV420 of its planes."""
    return out.tmap(copies.start) if is_planar(out) else copies.start(out)


def _landed(copy):
    """A started copy's host array (or planes), once the copy has run."""
    return copy.tmap(lambda c: c.wait().numpy()) if is_planar(copy) else copy.wait().numpy()


def generate_streaming(
    runner: Runner,
    images,  # [T, H, W, 3] frames, or PlanarYUV420
    cfg: PipelineConfig,
    debug: Optional[Debug] = None,
    progress_callback: Optional[Callable] = None,
    interrupt_fn: Optional[Callable] = None,
    packed: bool = False,
    *,
    noise=None,
):
    """The fused per-batch path (Runner.fused_batch, or fused_batch_chunks
    where the runner gives a column-chunk plan), with the deferred flush of
    the module docstring. Where the runner packs the sink's yuv420 planes, a
    ``packed`` caller gets a PlanarYUV420 of the whole clip; any other
    caller gets RGB (a batch's planes are put together first and converted
    on the host as whole frames, so column chunks leave no chroma seam).
    Raises torch.cuda.OutOfMemoryError where a batch does not fit (generate
    then takes another route)."""
    debug = debug or Debug()
    total = len(images)
    true_h, true_w = true_target_dims(images.shape[1], images.shape[2], cfg.resolution, cfg.max_resolution)
    specs = batching.compute_batches(total, cfg.batch_size, 0, cfg.uniform_batch_size)
    inoise = InputNoise(cfg, runner.device, as_draws(noise).inputs)
    copies = HostCopies(runner.device)
    final = None  # allocated at the first flush: RGB frames, or planes
    write = 0

    def flush(parts, ori):
        nonlocal final, write
        host = [(lo, hi, _landed(c)) for lo, hi, c in parts]
        if is_planar(host[0][2]):
            planes = host[0][2] if len(host) == 1 else PlanarYUV420(
                *(np.concatenate([getattr(h, k) for _, _, h in host], axis=2) for k in "yuv"), host[0][2].depth)
            planes = planes.to_numpy()
            if packed:
                if final is None:
                    final = planes.tmap(lambda p: np.zeros((total,) + p.shape[1:], p.dtype))
                for dst, src in zip((final.y, final.u, final.v), (planes.y, planes.u, planes.v)):
                    dst[write : write + ori] = src
            else:
                if final is None:
                    final = np.zeros((total, true_h, true_w, 3), np.float32)
                final[write : write + ori] = yuv420_to_rgb01_np(planes)
        else:
            if final is None:
                final = np.zeros((total, true_h, true_w, 3), _packed_dtype(cfg) if packed else np.float32)
            for lo, hi, codes in host:
                final[write : write + ori, :, lo:hi] = codes if packed else _unpack(codes, cfg)
        write += ori

    debug.start_timer("streaming_pipeline")
    if progress_callback:
        # one chain covers the four phases of a batch: phases 1-2 are
        # reported done up front, phase 3 per batch, phase 4 at the end, so
        # that a weighted progress bar only moves forward
        progress_callback(1, 1, 0, "Phase 1: Encoding")
        progress_callback(1, 1, 0, "Phase 2: Upscaling")
    pending = None
    for bi, spec in enumerate(specs):
        if interrupt_fn is not None:
            interrupt_fn()
        debug.start_timer(f"batch_{bi+1}")
        video = batching.prepare_batch(images, spec)
        fr = upload_frames(video if is_planar(video) else video[..., :3], runner.device)
        ori = spec.ori_length
        plan = runner.supports_chunked(fr.shape, true_h, true_w)
        if plan is not None:
            parts = [(lo, hi, _start_copy(copies, chunk)) for lo, hi, chunk in runner.fused_batch_chunks(
                fr, true_h, true_w, cfg.seed, plan, noise=noise, ori=ori, input_noise=inoise)]
        else:
            codes = runner.fused_batch(fr, true_h, true_w, cfg.seed, noise=noise, ori=ori, input_noise=inoise)
            parts = [(0, true_w, _start_copy(copies, codes))]
        if pending is not None:
            flush(*pending)
        pending = (parts, ori)
        debug.end_timer(f"batch_{bi+1}", f"Batch {bi+1}/{len(specs)} ({'column chunks' if plan else 'fused'})")
        debug.log_memory_state(f"after batch {bi+1}")
        if progress_callback:
            progress_callback(bi + 1, len(specs), ori, "Phase 3: Decoding")
    if pending is not None:
        flush(*pending)
    if progress_callback:
        progress_callback(1, 1, 0, "Phase 4: Post-processing")
    debug.end_timer("streaming_pipeline", "Fused streaming pipeline complete", show_breakdown=True)
    debug.peak_memory_summary()
    return final[:write]


# --------------------------------------------------------------------------- #
# The 4-phase path
# --------------------------------------------------------------------------- #


def make_context(cfg: PipelineConfig, debug: Optional[Debug] = None,
                 interrupt_fn: Optional[Callable] = None) -> Dict[str, Any]:
    """The state the four phases hand on, with the run log and the
    interrupt that every phase calls before each batch."""
    return {
        "cfg": cfg,
        "debug": debug or Debug(),
        "interrupt_fn": interrupt_fn,
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


def _check_interrupt(ctx: Dict[str, Any]) -> None:
    fn = ctx.get("interrupt_fn")
    if fn is not None:
        fn()


def _transform_batch(cfg: PipelineConfig, rgb: np.ndarray, device) -> torch.Tensor:
    """[T, H, W, 3] host frames -> [T, H', W', 3] fp32 in [-1, 1] on the
    device (resize, pad to /16, normalise)."""
    return pipeline_transform(to_f01(upload_frames(rgb, device)), cfg.resolution, cfg.max_resolution)


def _to_host_if(offload: bool, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if offload else t


@torch.inference_mode()
def encode_all_batches(runner: Runner, ctx: Dict[str, Any], images: np.ndarray,
                       progress_callback: Optional[Callable] = None, *,
                       input_noise: Optional[InputNoise] = None) -> Dict[str, Any]:
    """Phase 1: prepend frames, batch math, transform and VAE-encode every
    batch; the transformed frames are stashed on the device as the colour
    reference when the run budget allows. RGBA frames leave their alpha on
    the host for phase 4. ``input_noise`` augments the encoder's input
    (cfg.input_noise_scale; the colour reference stays clean)."""
    cfg: PipelineConfig = ctx["cfg"]
    debug: Debug = ctx["debug"]
    debug.log("Phase 1: VAE encoding", category="vae")
    debug.start_timer("phase1_encoding")
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
            _check_interrupt(ctx)
            debug.start_timer(f"encode_batch_{bi+1}")
            video = batching.prepare_batch(images, spec)
            if ctx["is_rgba"]:
                ctx["all_alpha"][bi] = video[..., 3:]
            tv = _transform_batch(cfg, video[..., :3], runner.device)
            if _stash_color_ref(cfg, ctx, runner):
                ctx["ref_device"][bi] = tv
            latent = runner.vae_encode(input_noise.apply(tv)[None].to(runner.compute_dtype))
            ctx["all_latents"][bi] = _to_host_if(_offload(cfg, ctx, runner), latent[0])
            debug.end_timer(f"encode_batch_{bi+1}", f"Encoded batch {bi+1}/{len(specs)}")
            if progress_callback:
                progress_callback(bi + 1, len(specs), spec.ori_length, "Phase 1: Encoding")
    debug.end_timer("phase1_encoding", "Phase 1: VAE encoding complete")
    debug.log_memory_state("after phase1")
    return ctx


@torch.inference_mode()
def upscale_all_batches(runner: Runner, ctx: Dict[str, Any], progress_callback: Optional[Callable] = None, *,
                        noise=None) -> Dict[str, Any]:
    """Phase 2: one DiT step per batch, each seeded alike (outputs do not
    depend on batch position); ``noise`` replaces every batch's draw. With
    phased_weights the DiT then leaves the device for the decode."""
    cfg: PipelineConfig = ctx["cfg"]
    debug: Debug = ctx["debug"]
    debug.start_timer("phase2_upscaling")
    n = len(ctx["all_latents"])
    ctx["all_upscaled"] = [None] * n
    with record_function("phase.upscale"):
        for bi in range(n):
            _check_interrupt(ctx)
            debug.start_timer(f"upscale_batch_{bi+1}")
            up = runner.upscale(ctx["all_latents"][bi][None], cfg.seed, noise)
            ctx["all_upscaled"][bi] = _to_host_if(_offload(cfg, ctx, runner), up[0])
            ctx["all_latents"][bi] = None
            debug.end_timer(f"upscale_batch_{bi+1}", f"Upscaled batch {bi+1}/{n}")
            if progress_callback:
                progress_callback(bi + 1, n, 1, "Phase 2: Upscaling")
    runner.release_dit()
    debug.end_timer("phase2_upscaling", "Phase 2: DiT upscaling complete")
    debug.log_memory_state("after phase2")
    return ctx


@torch.inference_mode()
def decode_all_batches(runner: Runner, ctx: Dict[str, Any],
                       progress_callback: Optional[Callable] = None) -> Dict[str, Any]:
    """Phase 3: decode every batch, trim its temporal and spatial padding,
    Hann-blend the overlap with the previous batch's tail, and write it into
    one host float32 video in [-1, 1] (with a fourth channel for phase 4's
    alpha when the input is RGBA)."""
    debug: Debug = ctx["debug"]
    debug.start_timer("phase3_decoding")
    true_h, true_w = ctx["true_dims"]
    final = np.zeros((ctx["total_frames"], true_h, true_w, 4 if ctx["is_rgba"] else 3), np.float32)
    overlap = ctx["actual_overlap"]
    specs = ctx["batches"]
    write = 0
    ctx["decode_info"] = []
    n = len(ctx["all_upscaled"])
    with record_function("phase.decode"):
        for bi, up in enumerate(ctx["all_upscaled"]):
            _check_interrupt(ctx)
            debug.start_timer(f"decode_batch_{bi+1}")
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
            debug.end_timer(f"decode_batch_{bi+1}", f"Decoded batch {bi+1}/{n}")
            if progress_callback:
                progress_callback(bi + 1, n, t, "Phase 3: Decoding")
    ctx["final_video"] = final[:write]
    debug.end_timer("phase3_decoding", "Phase 3: VAE decoding complete")
    debug.log_memory_state("after phase3")
    return ctx


@torch.inference_mode()
def postprocess_all_batches(runner: Runner, ctx: Dict[str, Any],
                            progress_callback: Optional[Callable] = None) -> Dict[str, Any]:
    """Phase 4: per batch, the colour fix against the transformed input
    (the phase-1 stash, or transformed again), trimmed like the output;
    [-1, 1] -> [0, 1]; an RGBA input's alpha upscaled against the result
    (pipeline/alpha.py); the prepended frames dropped."""
    cfg: PipelineConfig = ctx["cfg"]
    debug: Debug = ctx["debug"]
    debug.start_timer("phase4_postprocess")
    final = ctx["final_video"]
    specs = ctx["batches"]
    true_h, true_w = ctx["true_dims"]
    n = len(ctx["decode_info"])
    with record_function("phase.postprocess"):
        for i, (ws, we, bi, ori) in enumerate(ctx["decode_info"]):
            _check_interrupt(ctx)
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
            if progress_callback:
                progress_callback(i + 1, n, we - ws, "Phase 4: Post-processing")
    if cfg.prepend_frames > 0:
        final = final[cfg.prepend_frames :]
    ctx["final_video"] = final
    debug.end_timer("phase4_postprocess", "Phase 4: Post-processing complete")
    debug.log_memory_state("after phase4")
    return ctx


@torch.inference_mode()
def decode_and_postprocess_fused(runner: Runner, ctx: Dict[str, Any],
                                 progress_callback: Optional[Callable] = None) -> Dict[str, Any]:
    """Phases 3 and 4 per batch when no batch overlaps another and nothing
    was prepended: decode, then Runner.finalize_batch (trim, colour, pack)
    on the device; only the packed codes reach the host."""
    cfg: PipelineConfig = ctx["cfg"]
    debug: Debug = ctx["debug"]
    debug.start_timer("phase34_fused")
    true_h, true_w = ctx["true_dims"]
    specs = ctx["batches"]
    packed = bool(ctx.get("packed"))
    final = np.zeros((ctx["total_frames"], true_h, true_w, 3), _packed_dtype(cfg) if packed else np.float32)
    write = 0
    n = len(ctx["all_upscaled"])
    with record_function("phase.decode"):
        for bi, up in enumerate(ctx["all_upscaled"]):
            _check_interrupt(ctx)
            debug.start_timer(f"finalize_batch_{bi+1}")
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
            debug.end_timer(f"finalize_batch_{bi+1}", f"Finalized batch {bi+1}/{n}")
            if progress_callback:
                progress_callback(bi + 1, n, ori, "Phase 3: Decoding")
    if progress_callback:
        # colour and normalisation ran in finalize_batch: this path is phase 4 too
        progress_callback(1, 1, 0, "Phase 4: Post-processing")
    ctx["final_video"] = final[:write]
    debug.end_timer("phase34_fused", "Phases 3+4 (fused) complete")
    debug.log_memory_state("after phase34")
    return ctx


def _chunked_was_in_play(runner: Runner, images, cfg: PipelineConfig) -> bool:
    """Whether generate_streaming routes the clip's first batch through the
    column-chunk path (runner.supports_chunked gives a plan for its frame
    shape): only then is a monolithic retry a different attempt."""
    specs = batching.compute_batches(len(images), cfg.batch_size, 0, cfg.uniform_batch_size)
    if not specs:
        return False
    t = batching.frames_to_4n1(specs[0].ori_length + specs[0].uniform_padding)
    true_h, true_w = true_target_dims(images.shape[1], images.shape[2], cfg.resolution, cfg.max_resolution)
    return runner.supports_chunked((t, images.shape[1], images.shape[2], 3), true_h, true_w) is not None


def generate(
    runner: Runner,
    images,  # [T, H, W, 3|4]: float in [0, 1], uint8 or uint16; or PlanarYUV420
    cfg: Optional[PipelineConfig] = None,
    debug: Optional[Debug] = None,
    progress_callback: Optional[Callable] = None,
    interrupt_fn: Optional[Callable] = None,
    packed: bool = False,
    *,
    noise=None,
):
    """Frames THWC -> upscaled frames THWC: float32 in [0, 1], or with
    ``packed=True`` the uint16 / uint8 codes (cfg.output_bits) where the
    route packs on the device (the fused path, and the 4-phase path without
    overlap or prepended frames; the others, and RGBA, return float32, as
    in the JAX package). With cfg.output_pixfmt "yuv420" a ``packed``
    caller of the fused path gets a PlanarYUV420. The positional order is
    the JAX package's. ``debug``: the run log; ``progress_callback`` and
    ``interrupt_fn`` as the module docstring says. ``noise`` (keyword
    only): a Draws (or the DiT base noise [t, h, w, C] alone) replacing the
    generators' draws (tests). Out of memory: a run on the column-chunk
    route is rerun with one fused_batch a batch; a fused run that runs out
    of memory again, or that never used column chunks, is rerun on the
    4-phase path."""
    cfg = cfg or runner.cfg
    check_supported(cfg)
    debug = debug or Debug()
    t0 = time.perf_counter()
    can_stream = (
        cfg.fused_pipeline != "off"
        and batching.effective_overlap(cfg.batch_size, cfg.temporal_overlap) == 0
        and images.shape[-1] == 3
        and cfg.prepend_frames == 0
        and not cfg.phased_weights
        and cfg.tensor_offload != "always"
        and len(images) > 0
    )
    while can_stream:
        try:
            out = generate_streaming(runner, images, cfg, debug, progress_callback, interrupt_fn, packed, noise=noise)
        except torch.cuda.OutOfMemoryError:
            pass  # retried below, once this block has let go of the failed batch's tensors
        else:
            _log_rate(debug, len(out), t0)
            return out
        if runner.device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
        if _chunked_was_in_play(runner, images, cfg):
            runner._disable_chunked = True
            debug.log("HBM exhausted in the streamed column-chunk path; retrying the fused pipeline with one "
                      "fused_batch a batch", category="memory", force=True)
            continue
        debug.log("HBM exhausted in the fused pipeline; falling back to the phase-wise path with the tiling ladder",
                  category="memory", force=True)
        break
    if is_planar(images):
        # the 4-phase path works on RGB frames on the host: convert once here
        images = yuv420_to_rgb01_np(images.to_numpy()).astype(np.float32)
    ctx = make_context(cfg, debug, interrupt_fn)
    ctx["packed"] = packed
    debug.start_timer("generation")
    encode_all_batches(runner, ctx, images, progress_callback,
                       input_noise=InputNoise(cfg, runner.device, as_draws(noise).inputs))
    upscale_all_batches(runner, ctx, progress_callback, noise=noise)
    if ctx["actual_overlap"] == 0 and cfg.prepend_frames == 0 and not ctx["is_rgba"]:
        decode_and_postprocess_fused(runner, ctx, progress_callback)
    else:
        decode_all_batches(runner, ctx, progress_callback)
        postprocess_all_batches(runner, ctx, progress_callback)
    debug.end_timer("generation", "All phases complete", show_breakdown=True)
    debug.peak_memory_summary()
    _log_rate(debug, len(ctx["final_video"]), t0)
    return ctx["final_video"]


def _log_rate(debug: Debug, n: int, t0: float) -> None:
    dt = time.perf_counter() - t0
    debug.log(f"Generated {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps)", category="generation")


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
