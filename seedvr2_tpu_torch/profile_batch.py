"""Where the time of one run goes on the card: stage times, device kernel
time by kernel and the device's idle share, for a full-width model with
random weights.

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
runs under ``torch.profiler``, and its events give the rest: per stage (the
"runner.<stage>" ranges of Runner.fused_batch, or the "phase.<name>" ranges
of the 4-phase pipeline) the range's span on the device timeline, idle gaps
inside it included; per kernel its device time; and the idle share,
1 - (device time) / (profiled wall), not clamped (a negative share would
mean device time counted twice). A range's own device total on the host
side is not used: it misses the kernels launched through ctypes (K1-K9),
which have no PyTorch op above them. In the profiled run only, the VAE's
passes around the convs are ranges of their own (OP_RANGES: the GroupNorm
table pass of K4's route, the GroupNorm + SiLU passes outside K4 (the
unfused route's and ``norm_out``'s: K8's tables then K9), the mid
attention's GroupNorm (K8, K9), the convs that the routing rule keeps off
K1), each given as its calls and its summed device span (``op_span_ms``).
Every kernel is listed by name with its calls and device ms
(``kernels``); a kernel wrapper's launch count does not move in the
profiled run (its range's copy of the count does). Prints one JSON line.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import time

import numpy as np
import torch

from .config import PipelineConfig, pipeline_3b, pipeline_7b
from .io.checkpoint import load_text_embeddings
from .io.weights import random_dit, random_vae
from .pipeline import phases
from .pipeline.runner import Runner

STAGE_PREFIXES = ("runner.", "phase.")
# range -> (module, function): called inside a range of that name in the profiled run
OP_RANGES = {
    "op.gn_tables": (("seedvr2_tpu_torch.ops.conv3d_kernel", "gn_silu_tables"),),
    "op.gn_silu": (("seedvr2_tpu_torch.models.vae.causal_conv", "gn_silu"),
                   ("seedvr2_tpu_torch.models.vae.model", "gn_silu")),
    "op.mid_group_norm": (("seedvr2_tpu_torch.models.vae.model", "group_norm_frames"),),
}


def long_clip_config(cfg: PipelineConfig) -> PipelineConfig:
    """The long-clip path's settings: 9-frame batches overlapping by 3, the
    tiled VAE at the default tiles (1024 px, 128 px overlap), 1080p out."""
    return cfg.replace(resolution=1080, batch_size=9, temporal_overlap=3, encode_tiled=True, decode_tiled=True)


def long_clip_frames() -> np.ndarray:
    return np.random.RandomState(8).randint(0, 256, (15, 540, 960, 3)).astype(np.uint8)


@contextlib.contextmanager
def op_ranges():
    """OP_RANGES, and "op.conv_off_k1" around each CausalConv3d call that
    the routing rule sends to F.conv3d (layout copies included), for the
    length of the block; undone after it."""
    from .models.vae.causal_conv import CausalConv3d

    def ranged(name, fn):
        @functools.wraps(fn)  # with its attributes: a wrapper counts its launches on its module's name
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    targets = [(name, importlib.import_module(mod), attr) for name, pairs in OP_RANGES.items() for mod, attr in pairs]
    saved = [(m, attr, getattr(m, attr)) for _, m, attr in targets]
    conv_forward = CausalConv3d.forward

    def forward(self, *a, **kw):
        if self.k1:
            return conv_forward(self, *a, **kw)
        with torch.profiler.record_function("op.conv_off_k1"):
            return conv_forward(self, *a, **kw)

    try:
        for name, m, attr in targets:
            setattr(m, attr, ranged(name, getattr(m, attr)))
        CausalConv3d.forward = forward
        yield
    finally:
        for m, attr, fn in saved:
            setattr(m, attr, fn)
        CausalConv3d.forward = conv_forward


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
    with op_ranges(), torch.profiler.profile(activities=acts) as prof:
        prof_wall = timed_generate(runner, frames)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    stages_ms, ops_ms, kernels = {}, {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.key.startswith("op."):  # summed spans of the range's calls on the device timeline
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
        "idle_share": 1.0 - device_s / prof_wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "stage_span_ms": stages_ms, "op_span_ms": ops_ms, "kernels": kernels,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
