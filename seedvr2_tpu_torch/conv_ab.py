"""A/B of the hand-written kernels on the card: the convolutions K1, K4, K6
and K2 and the W8A16 linear K7 of this tree against the same kernels built
from other source trees, and the library call (cuDNN; for K7 cuBLAS's bf16
product on the weight dequantized beforehand), at the shapes of the main
paths (K6: of chip_smoke.py's phase 3; K7: its 7B video and text rows), in
turns within one process.

    python -m seedvr2_tpu_torch.conv_ab --against DIR [--against DIR ...] [--rounds 4] [--kernels K6]

Each DIR is a ``csrc/`` directory, for example the parent commit's,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Its ``conv3d.cu``, ``conv3d_im2col.cu``, ``fold_upsample.cu`` and (where it
has one) ``w8a16_linear.cu`` are compiled with this tree's ``nvcc`` flags
into a library of their own and called through the same C entry points
(``ops/cuda_lib.py:_SIGNATURES``), so DIR must keep them. ``--kernels``
picks a subset (K1 and K4 run together). ``--ablate`` adds, for every tree
whose kernel has the design they were written for and for each picked
kernel, copies of it with one part taken out (ABLATIONS). K6 (the TMA +
wgmma pipeline): the products (what the loads alone take) and the TMA
loads (the products and the epilogue alone, on whatever shared memory
holds). K7: the widening (the int8 bytes read as if they were bf16
pairs), the x fragment loads (one shared load a 16-step, reused), the
global loads (the ring stops after its prologue) and all three (the
mma.sync products and the epilogue alone). Their outputs are garbage,
their times say which part sets the pace. (Taking out the epilogue is no
such measure: ptxas then drops the products whose accumulators nothing
reads.)
Prints ptxas's register and spill report of every build, then per shape
each build's rel L2 against the plain version and, for ``--rounds`` rounds,
ms per call (CUDA events over 10 calls after a warm-up) of the library
call (for K2: on the folded weight) and of each build, in an order that
reverses every other round (a card near its power limit runs slower after
a heavy call, so a fixed order would favour one side). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from .ops import conv3d_kernel as k1
from .ops import cuda_lib
from .ops import fold_upsample_kernel as k2
from .ops import quant

CONV_SHAPES = ((512, 3, 180, 320), (256, 5, 360, 640), (128, 5, 720, 1280), (128, 5, 608, 1024), (256, 5, 304, 512))
K6_SHAPES = CONV_SHAPES[:3]
SOURCES = ("conv3d.cu", "conv3d_im2col.cu", "fold_upsample.cu", "w8a16_linear.cu")  # the last where a tree has it
FOLD_SHAPES = ((512, 2, 2, 2, 90, 160), (512, 2, 2, 3, 180, 320), (256, 3, 1, 7, 360, 640))  # C, kt, A, frames, H, W
K7_SHAPES = ((7200, 3072, 9216), (7200, 12288, 3072), (58, 3072, 9216))  # M, K, N: 7B qkv / proj_out video, qkv text

# kernel -> (header, a string of the design the ablations were written for)
ABLATED = {"K6": ("conv3d_im2col.cuh", "sm90::wgmma"), "K7": ("w8a16_linear.cuh", "widen_s8x4")}
_WIDEN = (r"widen_s8x4\((\*reinterpret_cast<const uint32_t\*>\(ws \+ n \* kWPitch \+ kk \+ 4 \* t\)), "
          r"b\[j\]\[0\], b\[j\]\[1\]\);", r"b[j][0] = b[j][1] = \1;")
_XLOAD = ((r"const uint2 r0 = \*reinterpret_cast<const uint2\*>\(xs \+ m \* kXPitch",
           "const uint2 r0 = *reinterpret_cast<const uint2*>(xs + g * kXPitch"),
          (r"const uint2 r8 = [^;]*;", "const uint2 r8 = r0;"))
_GLOAD = (r"if \(next < KT\)", "if (false)")
# name -> (kernel, (pattern, replacement) substitutions on its header, each
# of which must match at least once)
ABLATIONS = {
    "-products": ("K6", ((r"sm90::wgmma_m64n128k16_bf16\(.*?\);", ";"),)),
    "-loads": ("K6", ((r"sm90::mbar_arrive_expect_tx\((\w+) \+ (\w+), [^;]*\);", r"sm90::mbar_arrive(\1 + \2);"),
                      (r"sm90::tma_load_\dd\(.*?\);", ";"))),
    "-widen": ("K7", (_WIDEN,)),
    "-xload": ("K7", _XLOAD),
    "-gload": ("K7", (_GLOAD,)),
    "-all": ("K7", (_WIDEN, *_XLOAD, _GLOAD)),
}


def ablated(csrc: Path, out: Path, kernels) -> dict:
    """{suffix: (kernel, csrc copy)} with each of ABLATIONS of ``kernels``
    applied, for each kernel whose header in csrc has the design of
    ABLATED."""
    trees = {}
    for name, (kernel, subs) in ABLATIONS.items():
        header, design = ABLATED[kernel]
        if kernel not in kernels or not (csrc / header).exists() or design not in (csrc / header).read_text():
            continue
        text = (csrc / header).read_text()
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text, flags=re.S)
            if n == 0:
                raise RuntimeError(f"ablation {name}: {pat!r} matches nothing in {csrc}")
        tree = out / name.lstrip("-")
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(csrc, tree)
        (tree / header).write_text(text)
        trees[name] = (kernel, tree)
    return trees


def build_other(csrc: Path, out: Path):
    """(library, ptxas report) of csrc's SOURCES."""
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libconv_ab.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
           "-o", str(so), *(str(csrc / f) for f in SOURCES if (csrc / f).exists())]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("seedvr2_conv3d_3x3x3", "seedvr2_conv3d_im2col", "seedvr2_fold_upsample", "seedvr2_w8a16_linear"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = cuda_lib._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    return lib, ptxas_report(p.stdout + p.stderr)


def ptxas_report(log: str) -> str:
    """ptxas's spill and register lines of the conv kernels and K7, each after its kernel's name."""
    return "".join(f"\n  {name}: {line}" for name, line in cuda_lib.ptxas_lines(log)
                   if "conv" in name or "fold" in name or "w8a16" in name)


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
    ap.add_argument("--kernels", default="K1,K4,K6,K2,K7", help="comma-separated subset of K1,K4,K6,K2,K7")
    ap.add_argument("--ablate", action="store_true", help="also time K6 and K7 with one of their parts taken out")
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
    work = cuda_lib.BUILD_ROOT.parent / "conv_ab"
    kernels = set(args.kernels.split(","))
    others = {d: Path(d) for d in args.against}
    ablation_of = {}  # an ablated build's name -> its kernel
    if args.ablate:
        for i, (name, csrc) in enumerate([("this", cuda_lib.CSRC), *others.items()]):
            for k, (kernel, tree) in ablated(csrc, work / f"ablate{i}", kernels).items():
                others[name + k], ablation_of[name + k] = tree, kernel
    with ThreadPoolExecutor(len(others) or 1) as pool:
        outs = [work / str(i) for i in range(len(others))]
        for d, (lib, report) in zip(others, pool.map(build_other, others.values(), outs)):
            libs[d] = lib
            print(f"{d}:", report, flush=True)
    trees = {n: L for n, L in libs.items() if n not in ablation_of}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    for c, T, H, W in CONV_SHAPES:
        k14 = bool(kernels & {"K1", "K4"})
        k6 = "K6" in kernels and (c, T, H, W) in K6_SHAPES
        if not (k14 or k6):
            continue
        x, w = randn(1, T + 2, H, W, c), randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5)
        b = torch.randn(c, generator=g, device=dev)
        gw, gb = 1 + 0.2 * torch.randn(c, generator=g, device=dev), 0.3 * torch.randn(c, generator=g, device=dev)
        sc, sf = k1.gn_silu_tables(x, gw, gb, 32) if k14 else (None, None)
        y = torch.empty((1, T, H, W, c), dtype=torch.bfloat16, device=dev)
        ref1 = k1.conv3d_3x3x3_plain(x, w, b)
        xc, wo = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()

        def run(lib, gn):
            cuda_lib.check(lib.seedvr2_conv3d_3x3x3(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                                     sc.data_ptr() if gn else None, sf.data_ptr() if gn else None,
                                                     y.data_ptr(), 1, T, H, W, c, c, stream()), "conv3d_3x3x3")
            return y

        def run6(lib):
            cuda_lib.check(lib.seedvr2_conv3d_im2col(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                                      1, T, H, W, c, c, stream()), "conv3d_im2col")
            return y

        calls = {"cudnn": lambda: F.conv3d(xc, wo, b.bfloat16(), padding=(0, 1, 1))}
        if k14:
            ref4 = k1.conv3d_3x3x3_plain(x, w, b, sc, sf)
            errs = " ".join(f"{n} K1 {rel_l2(run(L, False), ref1):.2e} K4 {rel_l2(run(L, True), ref4):.2e}"
                            for n, L in trees.items())
            print(f"K1/K4 c{c} {T}x{H}x{W}: rel L2 {errs}", flush=True)
            for n, L in trees.items():
                calls[f"{n} K1"], calls[f"{n} K4"] = (lambda L=L: run(L, False)), (lambda L=L: run(L, True))
            del ref4
        if k6:
            libs6 = {n: L for n, L in libs.items() if ablation_of.get(n, "K6") == "K6"}
            errs = " ".join(f"{n} {rel_l2(run6(L), ref1):.2e}" for n, L in libs6.items())
            print(f"K6 c{c} {T}x{H}x{W}: rel L2 {errs}", flush=True)
            calls.update({f"{n} K6": (lambda L=L: run6(L)) for n, L in libs6.items()})
        timed_rounds(calls, args.rounds)
        del x, w, sc, sf, y, ref1, xc, wo

    for c, kt, A, frames, H, W in FOLD_SHAPES if "K2" in kernels else ():
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

        errs = " ".join(f"{n} {rel_l2(run2(L), ref):.2e}" for n, L in trees.items())
        print(f"K2 c{c} kt{kt} A{A} {frames}x{H}x{W}: rel L2 {errs}", flush=True)
        calls = {"cudnn": lambda: F.conv3d(xc, Ko, padding=(0, 1, 1))}
        calls.update({n: (lambda L=L: run2(L)) for n, L in trees.items()})
        timed_rounds(calls, args.rounds)
        del x, K, y, ref, xc, Ko

    libs7 = {n: L for n, L in libs.items() if ablation_of.get(n, "K7") == "K7" and hasattr(L, "seedvr2_w8a16_linear")}
    for M, K, N in K7_SHAPES if "K7" in kernels else ():
        q = quant.quantize_linear(torch.randn(K, N, generator=g, device=dev) * K**-0.5)
        w_q, w_s, w_deq = q["w_q"].t().contiguous(), q["w_s"], quant.dequantize_weight(q)
        x, y = randn(M, K), torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        ref = quant.linear_apply_plain(x, w_q, w_s)

        def run7(lib):
            cuda_lib.check(lib.seedvr2_w8a16_linear(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), None, y.data_ptr(),
                                                     M, N, K, stream()), "w8a16_linear")
            return y

        errs = " ".join(f"{n} {rel_l2(run7(L), ref):.2e}" for n, L in libs7.items())
        print(f"K7 M{M} K{K} N{N} ({2 * M * N * K / 1e9:.1f} GFLOP): rel L2 {errs}", flush=True)
        calls = {"cublas": lambda: x @ w_deq}
        calls.update({f"{n} K7": (lambda L=L: run7(L)) for n, L in libs7.items()})
        timed_rounds(calls, args.rounds)
        del q, w_q, w_s, w_deq, x, y, ref


if __name__ == "__main__":
    main()
