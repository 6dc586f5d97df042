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

from typing import Optional

import numpy as np
import torch

from ..ops.blending import blend_overlapping_frames
from ..ops.resize import true_target_dims
from ..parallel.comm import all_gather_cat
from ..parallel.mesh import AXIS_DATA, Mesh
from ..parallel.multihost import local_data_coords
from . import batching, phases
from .runner import Runner, _not_ported, check_supported


def generate_multichip(
    runner: Runner,
    images: np.ndarray,  # [T, H, W, 3]: float in [0, 1], uint8 or uint16
    mesh: Mesh,
    seam_overlap: int = 4,
    noise: Optional[torch.Tensor] = None,
) -> Optional[np.ndarray]:
    """Upscale ``images`` with every data rank of ``mesh``; every rank of
    the mesh calls this with the same arguments. Rank 0 returns the clip
    (float32 [T, H', W', 3] in [0, 1]); every other rank returns None.

    With one data rank, or fewer than 2 frames per data rank, every rank
    runs phases.generate on the whole clip (the DiT sharded over seq and
    tensor, the tiles of a tiled VAE over every rank). ``noise`` [t, h, w,
    C] replaces every batch's DiT noise draw, as in phases.generate.
    RGBA input and noise augmentation raise NotImplementedError, as they do
    in phases.generate."""
    cfg = runner.cfg
    check_supported(cfg)
    if images.shape[-1] != 3:
        raise _not_ported("RGBA input", "RGBA")
    n = mesh.shape[AXIS_DATA]
    if n == 1 or len(images) < 2 * n:
        out = phases.generate(runner, images, cfg, noise=noise)
        return out if mesh.rank == 0 else None

    if cfg.prepend_frames > 0:
        images = batching.pad_temporal_reversed(images, cfg.prepend_frames, prepend=True)
    total = len(images)
    ranges = batching.split_frame_ranges(total, n, seam_overlap)
    seg_lens = [e - s for s, e in ranges]
    target_len = batching.frames_to_4n1(max(seg_lens))  # one length: every rank runs the same batches
    s0, e0 = ranges[local_data_coords(mesh)[0]]  # this rank's own segment
    segment = batching.pad_temporal_reversed(images[s0:e0], target_len - (e0 - s0))
    specs = batching.compute_batches(target_len, cfg.batch_size, 0, uniform_batch_size=True)
    true_h, true_w = true_target_dims(images.shape[1], images.shape[2], cfg.resolution, cfg.max_resolution)

    lead = mesh.rank == 0
    out_segs = np.zeros((n, target_len, true_h, true_w, 3), np.float32) if lead else None
    write = 0
    for spec in specs:
        frames = phases.upload_frames(batching.prepare_batch(segment, spec), runner.device)
        codes = runner.fused_segment(frames, true_h, true_w, cfg.seed, noise=noise, ori=spec.ori_length)
        every = all_gather_cat(codes[None], mesh.group(AXIS_DATA), dim=0)  # [n, ori, h, w, 3] codes
        if lead:
            out_segs[:, write : write + spec.ori_length] = phases._unpack(every.cpu().numpy(), cfg)
        write += spec.ori_length
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
    if cfg.prepend_frames > 0:
        final = final[cfg.prepend_frames :]
    return final
