"""Run one cell of the port's benchmark once, on the card this process
sees, and print one JSON result line last on standard output.

    python -m portbench.run --workload 3b.video1080 --seed 7 --seconds 40 --trace 0

From the checkout's root. Set-up draws the configuration's weights on the
card from ``--seed`` (published layouts, through the program's loaders),
draws the traffic (the mix's kind, traffic/<kind>.py), and runs one batch
of each shape. The window then sends the cell's requests back to back, one
client, through the kind's call (clips: ``seedvr2_tpu_torch.pipeline.
phases.generate(runner, frames, cfg, packed=True)``), until ``--seconds``
have passed and a block of the mix's sizes is whole; the window runs from
the first request's start to the last one's end. ``--trace 1`` runs the same window under torch.profiler
with the ranges of probes.py and reports the per-layer metrics instead of
the end-to-end ones.

After the window the program is freed, the weights are drawn again and the
plain reference (reference/) recomputes a sample of the window's output
drawn from the seed (compare.py decides ``correct``).

Exit codes: 0 with a result; 2 for bad arguments; 3 without the CUDA
devices the cell asks for; 4 when a forbidden module (JAX or the JAX
package) was loaded; an exception's traceback otherwise.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here, before torch is imported

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "portbench"  # fixed directories inside the checkout for every compiler cache
FORBIDDEN = ("jax", "jaxlib", "flax", "seedvr2_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (seedvr2_tpu_torch is not seedvr2_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment() -> None:
    """Compiler caches inside the checkout, at fixed paths; no library may
    pull in JAX. Before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


@dataclass
class Run:
    """What the metrics read (metrics/*.py)."""

    frames: int  # output frames of the window's requests
    window_s: float
    request_s: List[float]
    setup_s: float
    peak_bytes: int
    trace: object = None  # trace.Trace of a traced window
    calls: object = None  # probes.Calls of a traced window
    failed: int = 0
    attempted: int = 0
    outputs: Dict[int, object] = field(default_factory=dict)  # request index -> packed codes


def torch_seed(seed: int) -> int:
    return abs(int(seed)) % (2**63)


def port_config(cell):
    """The program's PipelineConfig of a cell: the configuration file's
    model and precision, the mix's pipeline settings."""
    from seedvr2_tpu_torch.config import DiffusionConfig, DiTConfig, PipelineConfig, VAEConfig

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    c = cell.config
    return PipelineConfig(dit=DiTConfig(**tup(c["dit"])), vae=VAEConfig(**tup(c["vae"])),
                          diffusion=DiffusionConfig(**tup(c["diffusion"])), compute_dtype=c["precision"],
                          **tup(cell.traffic["pipeline"]))


def text_embedding(width: int):
    """The prompt embedding bundled with the program [58, width], read as
    data: both sides are handed the same array."""
    import numpy as np
    import seedvr2_tpu_torch

    path = Path(seedvr2_tpu_torch.__file__).resolve().parent / "assets" / "text_embeddings.npz"
    return np.load(path)["pos"][:, :width].astype(np.float32)


def dtype_of(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}[name]


def build_program(cell, seed: int, device, cfg):
    """The program's runner with the cell's weights drawn from ``seed``."""
    from seedvr2_tpu_torch.pipeline.runner import Runner

    from . import weights

    dtype = dtype_of(cell.config["precision"])
    dit_sd, vae_sd = weights.draw_models(cell.config, torch_seed(seed), device, dtype)
    dit, vae = weights.to_program(cfg, dit_sd, vae_sd, device, dtype, cell.config)
    return Runner(cfg, dit, vae, text_embedding(cfg.dit.txt_in_dim), device=device)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(runner, mix, cfg, seconds: float, device, trace_dit: Optional[dict] = None) -> Run:
    """The measured window (set-up fields left for the caller); traced
    where ``trace_dit`` gives the DiT's configuration (for work.py)."""
    import torch

    from . import probes
    from .trace import Trace

    spans: List[Tuple[float, float]] = []
    outputs: Dict[int, object] = {}
    failed = 0
    frames = 0

    def window():
        nonlocal failed, frames
        i = 0
        start = time.perf_counter()
        while True:
            req = mix.request(i)
            a = time.perf_counter()
            try:
                out = mix.call(runner, cfg, req)
            except Exception:  # a failed request counts against the run; the window goes on
                traceback.print_exc()
                failed += 1
            else:
                b = time.perf_counter()
                spans.append((a, b))
                outputs[i] = out
                frames += mix.frames_out(out)
            i += 1
            if i % mix.block == 0 and time.perf_counter() - start >= seconds:
                return i

    calls = None
    tr = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace_dit is not None:
        calls = probes.Calls(trace_dit)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with tempfile.TemporaryDirectory() as tmp:
            with probes.installed(calls), torch.profiler.profile(activities=acts) as prof:
                _sync(device)
                attempted = window()
                _sync(device)
            path = os.path.join(tmp, "trace.json.gz")
            prof.export_chrome_trace(path)
            del prof
            tr = Trace.load(path)
    else:
        attempted = window()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    lo = min(a for a, _ in spans) if spans else 0.0
    hi = max(b for _, b in spans) if spans else 0.0
    return Run(frames=frames, window_s=hi - lo, request_s=[b - a for a, b in spans], setup_s=0.0, peak_bytes=peak,
               trace=tr, calls=calls, failed=failed, attempted=attempted, outputs=outputs)


def sample_units(cell, mix, finished: List[int], seed: int) -> List[Tuple[int, int, int]]:
    """The compared part of the window's output, drawn from the seed:
    (request, first frame, end frame) units of one batch each, the largest
    request among them."""
    import numpy as np

    bs = mix.batch
    units = [(r, lo, min(lo + bs, mix.request(r).frames.shape[0])) for r in finished
             for lo in range(0, mix.request(r).frames.shape[0], bs)]
    n = min(int(cell.spec["sample"]["units"]), len(units))
    rng = np.random.default_rng([abs(int(seed)), 1])
    largest = [u for u in units if u[0] == mix.largest(finished)]
    first = largest[int(rng.integers(len(largest)))]
    rest = [u for u in units if u != first]
    return sorted([first] + [rest[k] for k in rng.choice(len(rest), n - 1, replace=False)])


def reference_codes(cell, seed: int, device, mix, cfg, units, precision: str = "fp32"):
    """The reference's codes of each unit, weights drawn again from the
    seed (on the same device, so with the same bits)."""
    import torch

    from . import weights
    from .reference.pipeline import Reference

    dit_sd, vae_sd = weights.draw_models(cell.config, torch_seed(seed), device, dtype_of(cell.config["precision"]))
    ref = Reference(cell.config, dit_sd, vae_sd, torch.from_numpy(text_embedding(cfg.dit.txt_in_dim)).to(device),
                    precision)
    out = [mix.reference_codes(ref, mix.request(r), lo, hi, device) for r, lo, hi in units]
    del ref, dit_sd, vae_sd
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", root: Path = ROOT,
             t0: Optional[float] = None) -> dict:
    """One run of a cell: the result line's object."""
    import torch

    from . import catalog, compare

    t0 = T0 if t0 is None else t0
    device = torch.device(device)
    cell = catalog.cell(name, root)
    cfg = port_config(cell)
    mix = catalog.generator(cell.traffic).Mix(cell.traffic, abs(int(seed)))
    cap = cell.spec.get("memory_cap_gib")
    if cap is not None and device.type == "cuda":  # the card as a smaller one: the program's allocator stops there
        torch.cuda.set_per_process_memory_fraction(cap * 2**30 / torch.cuda.get_device_properties(device).total_memory,
                                                   device)
    runner = build_program(cell, seed, device, cfg)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mix.warm(runner, cfg)
    _sync(device)
    setup_s = time.perf_counter() - t0

    run = measure(runner, mix, cfg, seconds, device, cell.config["dit"] if trace else None)
    run.setup_s = setup_s
    del runner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = catalog.metric(m)
        v = reader.read(run)
        if v is not None:
            metrics[m] = {"value": float(v), "unit": reader.UNIT}

    t_ref = time.perf_counter()
    finished = sorted(run.outputs)
    if finished:
        units = sample_units(cell, mix, finished, seed)
        refs = reference_codes(cell, seed, device, mix, cfg, units)
        readings = compare.gaps([(mix.program_codes(run.outputs[r], lo, hi), ref)
                                 for (r, lo, hi), ref in zip(units, refs)])
    else:
        readings = {n: 255.0 for n in compare.NAMES}
    ok, checks = compare.judge(readings, cell.spec["limits"])
    print(f"timing: setup_s {setup_s:.3f} window_s {run.window_s:.3f} requests {len(run.request_s)} "
          f"reference_s {time.perf_counter() - t_ref:.3f}", file=sys.stderr)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": bool(ok and run.failed == 0 and finished), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.trace is not None and run.trace.intervals:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.window_s
        lo, hi = run.trace.window_us()
        result["breakdown"] = {"device_ops": run.trace.top_ops(10), "idle_gaps": run.trace.idle_by_host(lo, hi, 10)}
        if run.trace.unlaunched:
            print(f"trace: {run.trace.unlaunched} device events without a launch record", file=sys.stderr)
        for rng, excl in (("pb.attn", "pb.attn_proj"), ("pb.conv", None)):
            print(f"trace: {rng} ops {json.dumps(run.trace.top_ops(6, rng, excl))}", file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    import torch

    from . import catalog

    cell = catalog.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
