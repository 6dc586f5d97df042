"""Frame-parallel generation over the mesh's "data" axis (counterpart of
seedvr2_tpu/pipeline/multichip.py).

The reference's multi-GPU mode: the clip is split into one frame segment
per data rank, with ``seam_overlap`` shared frames on every interior seam;
each segment is padded with reversed frames to one common 4n+1 length, so
that every rank runs the same batches; each rank runs the per-batch chain
on its own segment (Runner.fused_segment, its DiT sharded over the mesh's
seq and tensor axes if it has them); the packed outputs are all-gathered
over the data group and rank 0 trims the padding and Hann-blends the seams
(ops/blending.py). In the JAX package the segments are one "data"-sharded
batch of one SPMD program; here each rank is a process with its own
segment.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.blending import blend_overlapping_frames
from ..ops.resize import true_target_dims
from ..parallel.comm import all_gather_cat
from ..parallel.mesh import AXIS_DATA, Mesh
from ..parallel.multihost import local_data_coords
from ..utils.debug import Debug
from . import batching, phases
from .runner import InputNoise, Runner, as_draws, check_supported


def generate_multichip(
    runner: Runner,
    images: np.ndarray,  # [T, H, W, 3|4]: float in [0, 1], uint8 or uint16
    mesh: Mesh,
    seam_overlap: int = 4,
    debug: Optional[Debug] = None,
    progress_callback: Optional[Callable] = None,
    interrupt_fn: Optional[Callable] = None,
    *,
    noise=None,
) -> Optional[np.ndarray]:
    """Upscale ``images`` with every data rank of ``mesh``; every rank of
    the mesh calls this with the same arguments. Rank 0 returns the clip
    (float32 [T, H', W', 3|4] in [0, 1]); every other rank returns None.

    With one data rank, or fewer than 2 frames per data rank, every rank
    runs phases.generate on the whole clip (the DiT sharded over seq and
    tensor, the tiles of a tiled VAE over every rank). ``noise`` (keyword
    only; the positional order is the JAX package's) replaces
    the generators' draws, as in phases.generate; the input noise is one
    draw a batch of the clip, the same in every segment (Draws.inputs: one
    [T', H', W', 3] a batch). An RGBA input's alpha skips the models: rank
    0 upscales it against the blended RGB, batch_size frames at a time
    (pipeline/alpha.py).

    ``interrupt_fn`` is called before every batch (and may raise);
    ``progress_callback`` gets the fused path's protocol (phases 1 and 2
    done up front, phase 3 per batch, phase 4 at the end; frames counted
    over every segment), on rank 0 only. With one data rank both go to
    phases.generate."""
    cfg = runner.cfg
    check_supported(cfg)
    debug = debug or Debug()
    n = mesh.shape[AXIS_DATA]
    lead = mesh.rank == 0
    if n == 1 or len(images) < 2 * n:
        if n > 1:
            debug.log(f"multichip: {len(images)} frames < 2 per rank on data={n}; falling back to the single-clip "
                      "pipeline (the tile-parallel VAE still uses the mesh)", category="generation", force=True)
        out = phases.generate(runner, images, cfg, noise=noise, debug=debug,
                              progress_callback=progress_callback if lead else None, interrupt_fn=interrupt_fn)
        return out if lead else None

    if cfg.prepend_frames > 0:
        images = batching.pad_temporal_reversed(images, cfg.prepend_frames, prepend=True)
    total = len(images)
    alpha_in = images[..., 3:] if images.shape[-1] == 4 else None
    images = images[..., :3]
    ranges = batching.split_frame_ranges(total, n, seam_overlap)
    seg_lens = [e - s for s, e in ranges]
    target_len = batching.frames_to_4n1(max(seg_lens))  # one length: every rank runs the same batches
    s0, e0 = ranges[local_data_coords(mesh)[0]]  # this rank's own segment
    segment = batching.pad_temporal_reversed(images[s0:e0], target_len - (e0 - s0))
    specs = batching.compute_batches(target_len, cfg.batch_size, 0, uniform_batch_size=True)
    true_h, true_w = true_target_dims(images.shape[1], images.shape[2], cfg.resolution, cfg.max_resolution)

    input_noise = InputNoise(cfg, runner.device, as_draws(noise).inputs)
    progress = progress_callback if lead else None
    out_segs = np.zeros((n, target_len, true_h, true_w, 3), np.float32) if lead else None
    write = 0
    if progress:
        progress(1, 1, 0, "Phase 1: Encoding")
        progress(1, 1, 0, "Phase 2: Upscaling")
    for si, spec in enumerate(specs):
        if interrupt_fn is not None:
            interrupt_fn()
        frames = phases.upload_frames(batching.prepare_batch(segment, spec), runner.device)
        codes = runner.fused_segment(frames, true_h, true_w, cfg.seed, noise=noise, ori=spec.ori_length,
                                     input_noise=input_noise)
        every = all_gather_cat(codes[None], mesh.group(AXIS_DATA), dim=0)  # [n, ori, h, w, 3] codes
        if lead:
            out_segs[:, write : write + spec.ori_length] = phases._unpack(every.cpu().numpy(), cfg)
        write += spec.ori_length
        if progress:
            progress(si + 1, len(specs), spec.ori_length * n, "Phase 3: Decoding")
    if write < target_len - (cfg.batch_size - 1):
        raise RuntimeError(f"multichip batching drift: wrote {write} of {target_len} frames "
                           f"(batch_size={cfg.batch_size}, specs={len(specs)})")
    if not lead:
        return None

    # Assemble the segments in [0, 1], blending the seam overlaps (the Hann
    # blend is affine, so blending [0, 1] values equals blending [-1, 1] ones)
    final = np.zeros((total, true_h, true_w, 3), np.float32)
    pos = 0
    for i, (s, e) in enumerate(ranges):
        seg = out_segs[i, : seg_lens[i]]
        ov = pos - s if i > 0 else 0
        if ov > 0:
            final[s : s + ov] = blend_overlapping_frames(
                torch.from_numpy(final[s : s + ov]), torch.from_numpy(seg[:ov]), ov
            ).numpy()
        final[s + ov : e] = seg[ov:]
        pos = e
    if alpha_in is not None:
        from .alpha import upscale_alpha_batch

        alpha = np.zeros((total, true_h, true_w, 1), np.float32)
        for s0 in range(0, total, cfg.batch_size):
            e0 = min(s0 + cfg.batch_size, total)
            alpha[s0:e0, ..., 0] = upscale_alpha_batch(alpha_in[s0:e0], final[s0:e0], runner.device)
        final = np.concatenate([final, alpha], axis=-1)
    if cfg.prepend_frames > 0:
        final = final[cfg.prepend_frames :]
    if progress:
        progress(1, 1, 0, "Phase 4: Post-processing")
    return final
