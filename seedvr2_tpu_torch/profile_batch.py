"""Where the time of one run goes on the card: stage times and device
kernel time by kernel, for a full-width model with random weights.

    python -m seedvr2_tpu_torch.profile_batch --dit 7b --attention sageattn_2 [--runs 3] [--trace out.json]
    python -m seedvr2_tpu_torch.profile_batch --gn-fusion          # the same, resnet GroupNorm folded into K4
    python -m seedvr2_tpu_torch.profile_batch --phasewise --gn-fusion --runs 1

Default clip: chip_smoke.py's main path, 5 random 640x360 uint8 frames
upscaled to 1280x720 with the default pipeline settings (one fused batch).
``--phasewise``: chip_smoke.py's long-clip path, 15 random 960x540 frames
upscaled to 1920x1080 with batch_size 9, temporal_overlap 3 and the tiled
VAE at its default tiles, through the 4-phase pipeline. ``--gn-fusion``
turns the VAE's GroupNorm + SiLU fusion (K4) on.

``--runs`` timed ``phases.generate`` calls give the wall times; one more
runs under ``torch.profiler``, and its events give the rest, read from the
program's own ranges (utils/spans.py): per stage (the "runner.<stage>"
ranges of Runner.fused_batch, or the "phase.<name>" ranges of the 4-phase
pipeline; "generate" and the fused path's "stream.*" host steps) the
range's span on the device timeline, idle gaps inside it included
(``stage_span_ms``); per VAE pass around the convs ("vae.*":
every GroupNorm outside K4 and K4's tables, the mid attention, the causal
padding, the convs that the routing rule keeps off K1) its calls and its
summed device span (``op_span_ms``); every kernel by name with its calls
and device ms (``kernels``), and their sum (``device_kernel_s``; copies on
another stream overlap kernels, so it is no measure of idle time: the
benchmark's ``idle_share`` is, ``portbench/``). A range's own device total
on the host side is not used: it misses the kernels launched through
ctypes (K1-K9), which have no PyTorch op above them. Prints one JSON line.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .config import PipelineConfig, pipeline_3b, pipeline_7b
from .io.checkpoint import load_text_embeddings
from .io.weights import random_dit, random_vae
from .pipeline import phases
from .pipeline.runner import Runner

STAGE_PREFIXES = ("generate", "stream.", "runner.", "phase.")
OP_PREFIX = "vae."


def long_clip_config(cfg: PipelineConfig) -> PipelineConfig:
    """The long-clip path's settings: 9-frame batches overlapping by 3, the
    tiled VAE at the default tiles (1024 px, 128 px overlap), 1080p out."""
    return cfg.replace(resolution=1080, batch_size=9, temporal_overlap=3, encode_tiled=True, decode_tiled=True)


def long_clip_frames() -> np.ndarray:
    return np.random.RandomState(8).randint(0, 256, (15, 540, 960, 3)).astype(np.uint8)


def timed_generate(runner: Runner, frames: np.ndarray) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phases.generate(runner, frames)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dit", choices=("3b", "7b"), default="3b")
    ap.add_argument("--attention", default="fused", help="attention_mode name (fused, sageattn_2, flash_attn_2, ...)")
    ap.add_argument("--gn-fusion", action="store_true", help="fold the VAE's GroupNorm + SiLU into its convs (K4)")
    ap.add_argument("--phasewise", action="store_true", help="the long-clip path (15 x 960x540 -> 1080p, 4 phases)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the profiled run here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = (pipeline_7b if args.dit == "7b" else pipeline_3b)(resolution=720)
    frames = np.random.RandomState(7).randint(0, 256, (5, 360, 640, 3)).astype(np.uint8)
    if args.phasewise:
        cfg, frames = long_clip_config(cfg), long_clip_frames()
    g = torch.Generator(device=dev).manual_seed(42)
    dit = random_dit(cfg.dit, g).set_attention_mode(args.attention)
    vae = random_vae(cfg.vae, g).set_gn_fusion(args.gn_fusion)
    runner = Runner(cfg, dit, vae, load_text_embeddings()[0], device=dev)

    timed_generate(runner, frames)  # warm-up
    walls = [timed_generate(runner, frames) for _ in range(args.runs)]
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = timed_generate(runner, frames)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    stages_ms, ops_ms, kernels = {}, {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.key.startswith(OP_PREFIX):  # summed spans of the range's calls on the device timeline
            ops_ms[e.key] = {"calls": e.count, "ms": e.self_device_time_total / 1e3}
        elif e.key.startswith(STAGE_PREFIXES):  # the range's span on the device timeline
            stages_ms[e.key] = e.self_device_time_total / 1e3
        elif e.key != "Command Buffer Full" and e.self_device_time_total > 0:
            kernels.append({"name": e.key[:120], "calls": e.count, "ms": e.self_device_time_total / 1e3})
    kernels.sort(key=lambda k: -k["ms"])
    device_s = sum(k["ms"] for k in kernels) / 1e3
    out = {
        "device": torch.cuda.get_device_name(0), "dit": args.dit, "attention": args.attention,
        "gn_fusion": args.gn_fusion, "phasewise": args.phasewise, "frames": list(frames.shape),
        "wall_s": walls, "profiled_wall_s": prof_wall, "device_kernel_s": device_s,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "stage_span_ms": stages_ms, "op_span_ms": ops_ms, "kernels": kernels,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
