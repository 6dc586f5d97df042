"""The loader's cold and warm start, each load in a fresh process.

    python -m seedvr2_tpu_torch.load_probe --dir DIR [--against TREE] [--rounds 1] [--cases fp16,gguf,int8]
        [--variant 3b|7b] [--out build/load_probe.json]

``DIR`` receives the checkpoints once (seeded random weights at full width
in the released layout: NaDiT-3B or 7B and the VAE as fp16 safetensors,
the DiT also as a Q8_0 GGUF for the "gguf" case, through
io/weights.py:save_random_checkpoint and io/gguf.py:write_gguf). Then,
for each case, a cold load (the cache directory removed first) and a warm
one (the cache just written), each a ``load_runner`` on the card in a
child interpreter that imports only this tree's seedvr2_tpu_torch; with
``--against`` a second tree's (a parent commit unpacked with ``git
archive``: its loader has no cache, so its loads are all cold) in turns
with this one (parent, change, change, parent). A child reports its wall
(imports and CUDA start-up excluded), the process's ``ru_maxrss`` (which
counts the touched pages of memory-mapped files) and the peak of
``RssAnon`` (the anonymous memory alone, sampled every 2 ms from
/proc/self/status; where the kernel has no such line, as under gVisor,
the sum of the ``Anonymous:`` lines of /proc/self/smaps every 50 ms),
each also before the load; the parent adds the cache's
bytes on disk. Needs a CUDA card; prints one JSON line per load and writes
all of them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# The child's code: run with cwd = a tree's root, so that `import seedvr2_tpu_torch` is that tree's.
CHILD = r"""
import json, os, resource, sys, threading, time
args = json.loads(sys.argv[1])

with open("/proc/self/status") as f:
    HAS_RSS_ANON = any(ln.startswith("RssAnon:") for ln in f)
anon_source = "status RssAnon" if HAS_RSS_ANON else "smaps Anonymous"
interval = 0.002 if HAS_RSS_ANON else 0.05

def rss_anon():
    if HAS_RSS_ANON:
        with open("/proc/self/status") as f:
            return next(int(ln.split()[1]) for ln in f if ln.startswith("RssAnon:")) * 1024
    with open("/proc/self/smaps") as f:  # a kernel without RssAnon (gVisor): the mappings' anonymous pages
        return sum(int(ln.split()[1]) for ln in f if ln.startswith("Anonymous:")) * 1024

import torch
from seedvr2_tpu_torch.pipeline.loader import load_runner

torch.zeros(1, device="cuda").sum().item()  # the CUDA context outside the timed load
peak, stop = [rss_anon()], threading.Event()
anon0, maxrss0 = peak[0], resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

def sample():
    while not stop.is_set():
        peak[0] = max(peak[0], rss_anon())
        stop.wait(interval)

sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
t0 = time.perf_counter()
runner = load_runner(args["dit"], args["vae"], args["dir"], device="cuda", quantize=args["quantize"])
torch.cuda.synchronize()
wall = time.perf_counter() - t0
stop.set()
sampler.join()
peak[0] = max(peak[0], rss_anon())
print("LOAD_PROBE " + json.dumps({
    "wall_s": wall, "ru_maxrss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 2**30,
    "ru_maxrss_before_gib": maxrss0 / 2**30, "rss_anon_peak_gib": peak[0] / 2**30,
    "rss_anon_before_gib": anon0 / 2**30, "device_gib": torch.cuda.memory_allocated() / 2**30,
    "anon_source": anon_source, "dit_int8": runner.dit.quantize == "int8"}), flush=True)
"""

CASES = {  # case -> (DiT file, quantize)
    "fp16": ("seedvr2_ema_{v}_fp16.safetensors", None),
    "gguf": ("seedvr2_ema_{v}-Q8_0.gguf", None),
    "int8": ("seedvr2_ema_{v}_fp16.safetensors", "int8"),
}
VAE_FILE = "ema_vae_fp16.safetensors"


def make_checkpoints(d: Path, variant: str, cases) -> None:
    """The seeded fp16 safetensors (DiT and VAE) and, for "gguf", a Q8_0
    GGUF of the same DiT (F16 for the other matrices, F32 for vectors, as
    chip_smoke.py phase 10 writes it); files already there are kept."""
    import torch

    from .config import dit_3b, dit_7b, vae_config
    from .io import gguf
    from .io.checkpoint import load_safetensors
    from .io.weights import save_random_checkpoint

    d.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    st = d / CASES["fp16"][0].format(v=variant)
    if not st.exists():
        cfg = dit_7b() if variant == "7b" else dit_3b()
        save_random_checkpoint(str(st), "dit", cfg, torch.Generator(device=dev).manual_seed(11), torch.float16)
    if not (d / VAE_FILE).exists():
        save_random_checkpoint(str(d / VAE_FILE), "vae", vae_config(), torch.Generator(device=dev).manual_seed(12),
                               torch.float16)
    g = d / CASES["gguf"][0].format(v=variant)
    if "gguf" in cases and not g.exists():
        state = load_safetensors(str(st))
        gguf.write_gguf(str(g), {k: (v, gguf.Q8_0 if k.startswith("blocks.") and v.ndim == 2 else
                                     gguf.F16 if v.ndim >= 2 else gguf.F32) for k, v in state.items()})


def cache_bytes(d: Path) -> int:
    c = d / "torch_cache"
    return sum(f.stat().st_size for f in c.iterdir()) if c.is_dir() else 0


def run_child(tree: Path, d: Path, dit: str, quantize, timeout: float = 900) -> dict:
    """One load_runner in a fresh interpreter rooted at ``tree``."""
    args = json.dumps({"dit": dit, "vae": VAE_FILE, "dir": str(d.resolve()), "quantize": quantize})
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", CHILD, args], cwd=str(tree), env=env, capture_output=True,
                         text=True, timeout=timeout)
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith("LOAD_PROBE ")), None)
    if out.returncode != 0 or line is None:
        raise RuntimeError(f"load in {tree} failed ({out.returncode}):\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    rec = json.loads(line[len("LOAD_PROBE "):])
    rec["cache_log"] = [ln.strip() for ln in out.stdout.splitlines() if "Weights cache:" in ln]
    return rec


def probe(tree: Path, d: Path, case: str, variant: str, warm: bool) -> dict:
    """A cold load (the cache removed first) or a warm one, of ``case``."""
    dit, quantize = CASES[case]
    if not warm:
        shutil.rmtree(d / "torch_cache", ignore_errors=True)
    rec = run_child(tree, d, dit.format(v=variant), quantize)
    rec.update(tree=str(tree), case=case, variant=variant, load="warm" if warm else "cold",
               cache_gib=cache_bytes(d) / 2**30)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True, help="checkpoints and their cache (made here once)")
    ap.add_argument("--against", default=None, help="another tree's root (its loader's loads are all cold)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cases", default="fp16,gguf,int8")
    ap.add_argument("--variant", default="3b", choices=("3b", "7b"))
    ap.add_argument("--out", default="build/load_probe.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("load_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    d, cases = Path(args.dir), args.cases.split(",")
    t0 = time.perf_counter()
    make_checkpoints(d, args.variant, cases)
    files = {f.name: f.stat().st_size / 2**30 for f in d.iterdir() if f.is_file()}
    print(f"checkpoints in {time.perf_counter() - t0:.1f} s: {files}", flush=True)
    trees = [ROOT] if args.against is None else [Path(args.against).resolve(), ROOT, ROOT,
                                                   Path(args.against).resolve()]
    records = []
    for _ in range(args.rounds):
        for tree in trees:
            for case in cases:
                loads = [False] if tree != ROOT else [False, True]
                for warm in loads:
                    rec = probe(tree, d, case, args.variant, warm)
                    rec["card"] = card
                    records.append(rec)
                    print(json.dumps(rec), flush=True)
    shutil.rmtree(d / "torch_cache", ignore_errors=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "files_gib": files, "loads": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
