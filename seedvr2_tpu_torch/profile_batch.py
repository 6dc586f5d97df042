"""Where the time of one batch goes on the card: stage times, device kernel
time by kernel and the device's idle share, for a full-width model with
random weights.

    python -m seedvr2_tpu_torch.profile_batch --dit 7b --attention sageattn_2 [--runs 3] [--trace out.json]

The clip is chip_smoke.py's: 5 random 640x360 uint8 frames upscaled to
1280x720 with the default pipeline settings. ``--runs`` timed
``phases.generate`` calls give the wall times; one more runs under
``torch.profiler``, and its events give the rest: per stage (the
"runner.<stage>" ranges of Runner.fused_batch) the range's span on the
device timeline, idle gaps inside it included; per kernel its device time;
and the idle share, 1 - (device time) / (profiled wall), not clamped (a
negative share would mean device time counted twice). A range's own
device total on the host side is not used: it misses the kernels launched
through ctypes (K1-K5), which have no PyTorch op above them. Prints one
JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .config import pipeline_3b, pipeline_7b
from .io.checkpoint import load_text_embeddings
from .io.weights import random_dit, random_vae
from .pipeline import phases
from .pipeline.runner import Runner

STAGE_PREFIX = "runner."


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
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the profiled run here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = (pipeline_7b if args.dit == "7b" else pipeline_3b)(resolution=720)
    g = torch.Generator(device=dev).manual_seed(42)
    dit = random_dit(cfg.dit, g).set_attention_mode(args.attention)
    runner = Runner(cfg, dit, random_vae(cfg.vae, g), load_text_embeddings()[0], device=dev)
    frames = np.random.RandomState(7).randint(0, 256, (5, 360, 640, 3)).astype(np.uint8)

    timed_generate(runner, frames)  # warm-up
    walls = [timed_generate(runner, frames) for _ in range(args.runs)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = timed_generate(runner, frames)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    stages_ms, kernels = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.key.startswith(STAGE_PREFIX):  # the range's span on the device timeline
            stages_ms[e.key[len(STAGE_PREFIX):]] = e.self_device_time_total / 1e3
        elif e.key != "Command Buffer Full" and e.self_device_time_total > 0:
            kernels.append({"name": e.key[:120], "calls": e.count, "ms": e.self_device_time_total / 1e3})
    kernels.sort(key=lambda k: -k["ms"])
    device_s = sum(k["ms"] for k in kernels) / 1e3
    out = {
        "device": torch.cuda.get_device_name(0), "dit": args.dit, "attention": args.attention,
        "wall_s": walls, "profiled_wall_s": prof_wall, "device_kernel_s": device_s,
        "idle_share": 1.0 - device_s / prof_wall, "stage_span_ms": stages_ms, "top_kernels": kernels[:25],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
