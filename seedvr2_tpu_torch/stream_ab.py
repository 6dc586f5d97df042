"""The fused route's output stream on the card: where the device -> host
copies run, how much of them a kernel hides and the calls that make the
host wait, for one ``phases.generate`` run; and an A/B of this tree against
other source trees on one clip. The device's idle share is the benchmark's
reading (portbench's ``idle_share``).

    python -m seedvr2_tpu_torch.stream_ab --against DIR [--against DIR ...] [--rounds 2]

The clip: 15 random 640x360 frames upscaled to 1280x720 in three 5-frame
batches by 3B + VAE (random bf16 weights from a seed, wavelet, 16-bit
codes) with the decode tiled at its default 1024 / 128 px tiles, so that
this tree's chunk route (``chunked_output="auto"``) has one row of two
column tiles. Each tree runs in a process of its own (a DIR is the root of
another tree, e.g. the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists), in an order that reverses every
other round (tree A, B, B, A for two rounds). In each process, for each
route (a tree without the chunk route has one), a warm-up, three timed
runs, one run under torch.profiler (``trace_copies``) and one under
torch.cuda.set_sync_debug_mode (``sync_census``). Prints one JSON line per
process and route, then a summary line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = (15, 360, 640, 3)


def overlap_us(spans, covered) -> float:
    """Length of ``spans`` that lies inside the union of ``covered``."""
    merged = []
    for s, e in sorted(covered):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [m[0] for m in merged]
    total = 0.0
    for s, e in spans:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(merged) and merged[i][0] < e:
            total += max(0.0, min(e, merged[i][1]) - max(s, merged[i][0]))
            i += 1
    return total


def trace_copies(runner, frames) -> dict:
    """One phases.generate (packed) under torch.profiler (CPU + CUDA): the
    device -> host copies' count, bytes and ms, and the ms of them that
    overlap a kernel on the compute stream (the stream that runs most
    kernels)."""
    import torch

    from seedvr2_tpu_torch.pipeline import phases

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        phases.generate(runner, frames, packed=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels, copies, streams = [], [], {}
    for e in events:
        cat, dur = e.get("cat", ""), e.get("dur")
        if dur is None or cat not in ("kernel", "gpu_memcpy"):
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(dur))
        stream = e.get("args", {}).get("stream")
        if cat == "kernel":
            kernels.append((stream, span))
            streams[stream] = streams.get(stream, 0) + 1
        elif "DtoH" in e.get("name", ""):
            copies.append((stream, span, int(e.get("args", {}).get("bytes", 0))))
    if not kernels or not copies:
        raise RuntimeError(f"trace: {len(kernels)} kernels, {len(copies)} device->host copies")
    compute = max(streams, key=streams.get)
    spans = [s for _, s, _ in copies]
    return {"wall_s": wall, "d2h_count": len(copies), "d2h_bytes": sum(b for _, _, b in copies),
            "d2h_ms": sum(e - s for s, e in spans) / 1e3,
            "d2h_overlapping_compute_ms": overlap_us(spans, [s for st, s in kernels if st == compute]) / 1e3,
            "d2h_streams": sorted({str(st) for st, _, _ in copies}), "compute_stream": str(compute)}


def sync_census(runner, frames) -> dict:
    """The calls that made the host wait on the card in one phases.generate
    (packed): torch.cuda.set_sync_debug_mode("warn") warns at each
    synchronizing operation; each is counted under the innermost line of
    the package that led to it (with the line outside it that issued it),
    except the first switch of the mode itself. The flush's waits, each on
    its copy's own event, are no such operation."""
    import traceback
    import warnings

    import torch

    from seedvr2_tpu_torch.pipeline import phases

    package = os.path.dirname(os.path.dirname(os.path.abspath(phases.__file__)))  # .../seedvr2_tpu_torch
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
    sites = {}

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        caller = next((f for f in reversed(stack)
                       if not f.filename.startswith(torch_dir) and f.filename != warnings.__file__), None)
        if caller is not None and caller.name == "sync_census":  # switching the mode itself
            return
        ours = [f for f in stack if f.filename.startswith(package + os.sep)]
        where = (f"{os.path.relpath(ours[-1].filename, os.path.dirname(package))}:{ours[-1].lineno}" if ours
                 else "outside the package")
        if not filename.startswith(package + os.sep):
            where += f" via {os.path.basename(filename)}:{lineno}"
        sites[where] = sites.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            phases.generate(runner, frames, packed=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def _worker(root: str) -> None:
    """One tree's runs (the package imported from ``root``): JSON lines.
    Runs as a script, so its own directory leaves the path first."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or os.curdir) != here]
    import hashlib

    import numpy as np
    import torch

    from seedvr2_tpu_torch.config import PipelineConfig
    from seedvr2_tpu_torch.io.weights import load_text_embeddings, random_dit, random_vae
    from seedvr2_tpu_torch.ops import cuda_lib
    from seedvr2_tpu_torch.pipeline import phases
    from seedvr2_tpu_torch.pipeline.runner import Runner

    if not phases.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {phases.__file__}, not the tree at {root}")
    cuda_lib.build()
    cuda_lib.library()
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig(resolution=720, decode_tiled=True)
    g = torch.Generator(device=dev).manual_seed(46)
    runner = Runner(cfg, random_dit(cfg.dit, g), random_vae(cfg.vae, g), load_text_embeddings()[0], device=dev)
    clip = np.random.RandomState(13).randint(0, 256, CLIP).astype(np.uint8)
    routes = ("auto", "off") if hasattr(runner, "supports_chunked") else ("monolithic",)
    for route in routes:
        r = runner.with_config(cfg.replace(chunked_output="off" if route == "monolithic" else route))
        codes = phases.generate(r, clip, packed=True)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phases.generate(r, clip, packed=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(json.dumps({"tree": root, "route": route, "walls_s": walls,
                          "codes_sha1": hashlib.sha1(np.ascontiguousarray(codes).tobytes()).hexdigest()[:12],
                          **trace_copies(r, clip), "syncs": sync_census(r, clip)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], help="root of another source tree")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(os.path.abspath(args.worker))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("stream_ab: no CUDA device")
    trees = [ROOT] + [os.path.abspath(d) for d in args.against]
    rows = []
    for rnd in range(args.rounds):
        for root in (trees if rnd % 2 == 0 else trees[::-1]):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root], check=True,
                                 stdout=subprocess.PIPE, text=True).stdout
            for line in out.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    rows.append(json.loads(line))
    summary = {}
    for row in rows:
        key = f"{os.path.relpath(row['tree'], ROOT) if row['tree'] != ROOT else 'this tree'} {row['route']}"
        entry = summary.setdefault(key, {"walls_s": [], "d2h_ms": [], "codes_sha1": set()})
        entry["walls_s"] += row["walls_s"]
        entry["d2h_ms"].append(row["d2h_ms"])
        entry["codes_sha1"].add(row["codes_sha1"])
    for entry in summary.values():
        entry["median_wall_s"] = sorted(entry["walls_s"])[len(entry["walls_s"]) // 2]
        entry["codes_sha1"] = sorted(entry["codes_sha1"])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "summary": summary}))


if __name__ == "__main__":
    main()
