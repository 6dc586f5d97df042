"""Host-side batch index math: temporal overlap, 4n+1 padding, uniform
batches (the port's copy of seedvr2_tpu/pipeline/batching.py). Pure numpy:
this shapes the frames before they reach the card.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class BatchSpec(NamedTuple):
    start: int
    end: int
    uniform_padding: int  # frames added to reach uniform batch_size
    ori_length: int  # frames before any padding


def compute_batches(
    total_frames: int,
    batch_size: int,
    temporal_overlap: int = 0,
    uniform_batch_size: bool = False,
) -> List[BatchSpec]:
    """Step = batch - overlap; a trailing batch fully inside the overlap is
    dropped."""
    step = batch_size - temporal_overlap if temporal_overlap > 0 else batch_size
    if step <= 0:
        step = batch_size
        temporal_overlap = 0
    out: List[BatchSpec] = []
    for idx in range(0, total_frames, step):
        if idx == 0:
            start, end = 0, min(batch_size, total_frames)
        else:
            start = idx
            end = min(start + batch_size, total_frames)
            if end - start <= temporal_overlap:
                break
        n = end - start
        pad = batch_size - n if (uniform_batch_size and n < batch_size) else 0
        out.append(BatchSpec(start, end, pad, n))
    return out


def effective_overlap(batch_size: int, temporal_overlap: int) -> int:
    return 0 if temporal_overlap >= batch_size else temporal_overlap


def optimal_batch_size(total_frames: int) -> int:
    """The largest 4n+1 <= total_frames (1 for an empty clip)."""
    valid = [i for i in range(1, total_frames + 1) if i % 4 == 1]
    return max(valid) if valid else 1


def pad_temporal_reversed(video: np.ndarray, count: int, prepend: bool = False) -> np.ndarray:
    """Extend with time-reversed frames (temporal axis 0)."""
    t = video.shape[0]
    if count <= 0:
        return video
    if count >= t:
        repeat_count = count - t + 1
        last = video[-1:]
        repeated = np.repeat(last, repeat_count, axis=0)
        reversed_frames = video[1:][::-1] if t > 1 else video[:0]
        parts = [repeated, reversed_frames, video] if prepend else [video, reversed_frames, repeated]
        return np.concatenate(parts, axis=0)
    if prepend:
        reversed_frames = video[1 : count + 1][::-1]
        return np.concatenate([reversed_frames, video], axis=0)
    reversed_frames = video[-count - 1 : -1][::-1]
    return np.concatenate([video, reversed_frames], axis=0)


def pad_to_4n1(video: np.ndarray) -> np.ndarray:
    """Append reversed frames to reach T % 4 == 1."""
    t = video.shape[0]
    if t % 4 == 1:
        return video
    target = ((t - 1) // 4 + 1) * 4 + 1
    return pad_temporal_reversed(video, target - t)


def frames_to_4n1(t: int) -> int:
    return t if t % 4 == 1 else ((t - 1) // 4 + 1) * 4 + 1


def prepare_batch(images: np.ndarray, spec: BatchSpec) -> np.ndarray:
    """Slice one batch, add uniform padding, pad to 4n+1 frames. Planar
    yuv420 frames (ops/yuv.py) get the same treatment on every plane."""
    from ..ops.yuv import is_planar

    if is_planar(images):
        return images[spec.start : spec.end].tmap(
            lambda p: pad_to_4n1(pad_temporal_reversed(p, spec.uniform_padding)))
    video = images[spec.start : spec.end]
    if spec.uniform_padding > 0:
        video = pad_temporal_reversed(video, spec.uniform_padding)
    return pad_to_4n1(video)


def split_frame_ranges(total_frames: int, num_shards: int, overlap: int) -> List[tuple]:
    """Frame-parallel split across ranks with ``overlap`` extra frames on
    every interior seam (reference: inference_cli.py:1160-1182)."""
    base = total_frames // num_shards
    extra = total_frames % num_shards
    ranges = []
    start = 0
    for i in range(num_shards):
        n = base + (1 if i < extra else 0)
        end = min(start + n + (overlap if i < num_shards - 1 else 0), total_frames)
        ranges.append((start, end))
        start += n
    return ranges
