"""A/B of the convolution kernels on the card: K1, K4 and K2 of this tree
against the same kernels built from other source trees, and cuDNN, at the
shapes of the main paths, in turns within one process.

    python -m seedvr2_tpu_torch.conv_ab --against DIR [--against DIR ...] [--rounds 4]

Each DIR is a ``csrc/`` directory, for example the parent commit's,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Its ``conv3d.cu`` and ``fold_upsample.cu`` are compiled with this tree's
``nvcc`` flags into a library of their own and called through the same C
entry points (``ops/cuda_lib.py:_SIGNATURES``), so DIR must keep them.
Prints ptxas's register and spill report of every build, then per shape
each build's rel L2 against the plain version and, for ``--rounds`` rounds,
ms per call (CUDA events over 10 calls after a warm-up) of cuDNN's bf16
``F.conv3d`` (for K2: of the folded weight) and of each build, in an order
that reverses every other round (a card near its power limit runs slower
after a heavy call, so a fixed order would favour one side). Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from .ops import conv3d_kernel as k1
from .ops import cuda_lib
from .ops import fold_upsample_kernel as k2

CONV_SHAPES = ((512, 3, 180, 320), (256, 5, 360, 640), (128, 5, 720, 1280), (128, 5, 608, 1024), (256, 5, 304, 512))
FOLD_SHAPES = ((512, 2, 2, 2, 90, 160), (512, 2, 2, 3, 180, 320), (256, 3, 1, 7, 360, 640))  # C, kt, A, frames, H, W


def build_other(csrc: Path, out: Path):
    """(library, ptxas report) of csrc's conv3d.cu and fold_upsample.cu."""
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libconv_ab.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
           "-o", str(so), str(csrc / "conv3d.cu"), str(csrc / "fold_upsample.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("seedvr2_conv3d_3x3x3", "seedvr2_fold_upsample"):
        getattr(lib, fn).argtypes = cuda_lib._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, ptxas_report(p.stdout + p.stderr)


def ptxas_report(log: str) -> str:
    """ptxas's spill and register lines of the conv kernels, each after its kernel's name."""
    out, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif ("spill" in line or "registers" in line) and ("conv" in name or "fold" in name):
            out.append(f"\n  {name}: {line.replace('ptxas info    :', '').strip()}")
    return "".join(out)


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_rounds(calls: dict, rounds: int) -> None:
    """One line of ms per call for each round, the order reversed every other round."""
    for r in range(rounds):
        names = list(calls) if r % 2 == 0 else list(calls)[::-1]
        t = {n: cuda_ms(calls[n]) for n in names}
        print("   " + " | ".join(f"{n} {t[n]:.3f}" for n in calls), flush=True)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--against", action="append", default=[], help="a csrc/ directory to build and time beside this tree")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_ab: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), torch.__version__, flush=True)
    here = cuda_lib.library()
    print("this tree:", ptxas_report(cuda_lib.build().log), flush=True)
    libs = {"this": here}
    with ThreadPoolExecutor(len(args.against) or 1) as pool:
        outs = [cuda_lib.BUILD_ROOT.parent / "conv_ab" / str(i) for i in range(len(args.against))]
        for d, (lib, report) in zip(args.against, pool.map(build_other, map(Path, args.against), outs)):
            libs[d] = lib
            print(f"{d}:", report, flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    for c, T, H, W in CONV_SHAPES:
        x, w = randn(1, T + 2, H, W, c), randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5)
        b = torch.randn(c, generator=g, device=dev)
        gw, gb = 1 + 0.2 * torch.randn(c, generator=g, device=dev), 0.3 * torch.randn(c, generator=g, device=dev)
        sc, sf = k1.gn_silu_tables(x, gw, gb, 32)
        y = torch.empty((1, T, H, W, c), dtype=torch.bfloat16, device=dev)
        ref1, ref4 = k1.conv3d_3x3x3_plain(x, w, b), k1.conv3d_3x3x3_plain(x, w, b, sc, sf)
        xc, wo = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()

        def run(lib, gn):
            cuda_lib.check(lib.seedvr2_conv3d_3x3x3(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                                     sc.data_ptr() if gn else None, sf.data_ptr() if gn else None,
                                                     y.data_ptr(), 1, T, H, W, c, c, stream()), "conv3d_3x3x3")
            return y

        errs = " ".join(f"{n} K1 {rel_l2(run(L, False), ref1):.2e} K4 {rel_l2(run(L, True), ref4):.2e}"
                        for n, L in libs.items())
        print(f"K1/K4 c{c} {T}x{H}x{W}: rel L2 {errs}", flush=True)
        calls = {"cudnn": lambda: F.conv3d(xc, wo, b.bfloat16(), padding=(0, 1, 1))}
        for n, L in libs.items():
            calls[f"{n} K1"], calls[f"{n} K4"] = (lambda L=L: run(L, False)), (lambda L=L: run(L, True))
        timed_rounds(calls, args.rounds)
        del x, w, sc, sf, y, ref1, ref4, xc, wo

    for c, kt, A, frames, H, W in FOLD_SHAPES:
        x, K = randn(1, frames, H, W, c), randn(kt, 2, 2, c, A * 4 * c, scale=(kt * 4 * c) ** -0.5)
        bt, bc = torch.randn(2, 2, A * 4 * c, generator=g, device=dev), torch.randn(c, generator=g, device=dev)
        Tp = frames - kt + 1
        y = torch.empty((1, Tp * A, 2 * H, 2 * W, c), dtype=torch.bfloat16, device=dev)
        ref = k2.fold_upsample_conv_plain(x, K, bt, bc, A)
        xc, Ko = x.permute(0, 4, 1, 2, 3), K.permute(4, 3, 0, 1, 2).contiguous()

        def run2(lib):
            cuda_lib.check(lib.seedvr2_fold_upsample(x.data_ptr(), K.data_ptr(), bt.data_ptr(), bc.data_ptr(),
                                                      y.data_ptr(), 1, Tp, kt, A, H, W, c, stream()), "fold_upsample")
            return y

        errs = " ".join(f"{n} {rel_l2(run2(L), ref):.2e}" for n, L in libs.items())
        print(f"K2 c{c} kt{kt} A{A} {frames}x{H}x{W}: rel L2 {errs}", flush=True)
        calls = {"cudnn": lambda: F.conv3d(xc, Ko, padding=(0, 1, 1))}
        calls.update({n: (lambda L=L: run2(L)) for n, L in libs.items()})
        timed_rounds(calls, args.rounds)
        del x, K, y, ref, xc, Ko


if __name__ == "__main__":
    main()
