"""End-to-end generation, fused per-batch path (counterpart of
seedvr2_tpu/pipeline/phases.py: generate -> generate_streaming ->
Runner.fused_batch). Batch math (4n+1 padding, uniform batches) is in
pipeline/batching.py.

Batches run one after another; overlapping batch i+1's compute with batch
i's device->host copy (pinned buffers, a copy stream) is later work.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.resize import true_target_dims
from . import batching
from .runner import Runner, _not_ported, check_supported


def upload_frames(rgb: np.ndarray, device) -> torch.Tensor:
    """Host frames -> device at 1-2 bytes a channel where possible: uint8 as
    is, 16-bit codes as int32 (scaled on the device), floats as float16."""
    if rgb.dtype == np.uint8:
        t = torch.from_numpy(np.ascontiguousarray(rgb))
    elif rgb.dtype == np.uint16:
        t = torch.from_numpy(rgb.astype(np.int32))
    else:
        t = torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.float16))
    return t.to(device)


def generate_streaming(
    runner: Runner,
    images: np.ndarray,
    cfg: PipelineConfig,
    packed: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> np.ndarray:
    total = len(images)
    true_h, true_w = true_target_dims(images.shape[1], images.shape[2], cfg.resolution, cfg.max_resolution)
    specs = batching.compute_batches(total, cfg.batch_size, 0, cfg.uniform_batch_size)
    packed_dtype = np.uint8 if cfg.output_bits == 8 else np.uint16
    final = np.zeros((total, true_h, true_w, 3), packed_dtype if packed else np.float32)
    scale = 255.0 if cfg.output_bits == 8 else 65535.0
    write = 0
    for spec in specs:
        fr = upload_frames(batching.prepare_batch(images, spec)[..., :3], runner.device)
        codes = runner.fused_batch(fr, true_h, true_w, cfg.seed, noise=noise)
        host = codes[: spec.ori_length].cpu().numpy()
        final[write : write + spec.ori_length] = host.astype(packed_dtype) if packed else host.astype(np.float32) / np.float32(scale)
        write += spec.ori_length
    return final[:write]


def generate(
    runner: Runner,
    images: np.ndarray,  # [T, H, W, 3]: float in [0, 1], uint8 or uint16
    cfg: Optional[PipelineConfig] = None,
    packed: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Frames THWC -> upscaled frames THWC: float32 in [0, 1], or with
    ``packed=True`` the uint16 / uint8 codes (cfg.output_bits). ``noise``
    [t, h, w, C] replaces every batch's DiT noise draw (tests)."""
    cfg = cfg or runner.cfg
    check_supported(cfg)
    if batching.effective_overlap(cfg.batch_size, cfg.temporal_overlap) > 0:
        raise _not_ported("temporal_overlap > 0", "the rest of the pipeline")
    if images.shape[-1] != 3:
        raise _not_ported("RGBA input", "the rest of the pipeline")
    return generate_streaming(runner, images, cfg, packed=packed, noise=noise)
