"""A/B of the hand-written kernels on the card: the convolutions K1, K4, K6
and K2, the W8A16 linear K7, the window attention K3 / K3q, the masked
attention K5 and the GroupNorm statistics K8 of this tree against the same
kernels built from other source trees, and the library call (cuDNN; for K7
cuBLAS's bf16 product on the weight dequantized beforehand; for K3 SDPA on
q/k already normalised and roped; for K5 SDPA with the key mask; for K8
``torch.var_mean`` over the grouped bf16 view), at the shapes of the main
paths (K3, K3q, K5, K6, K7 and K8: those of chip_smoke.py's phase 3), in
turns within one process.

    python -m seedvr2_tpu_torch.conv_ab --against DIR [--against DIR ...] [--rounds 4] [--kernels K6]

Each DIR is a ``csrc/`` directory, for example the parent commit's,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Its ``conv3d.cu``, ``conv3d_im2col.cu`` (trees before K1 and K6 shared a
kernel), ``fold_upsample.cu`` and (where it has them) ``w8a16_linear.cu``,
``window_attention.cu``, ``window_qk_prepare.cu``, ``flash_attention.cu``
and ``gn_stats.cu`` are compiled with this tree's ``nvcc`` flags into a
library of their own and called through the same C entry points
(``ops/cuda_lib.py:_SIGNATURES``; K3 of a tree before the prepared design
through its single entry, ``OLD_WINDOW_ATTENTION``), so DIR must keep
them. A tree without ``gn_stats.cu`` computed K4's tables with the plain
version, which is timed in its place ("plain tables"). ``--kernels`` picks a
subset (K1 and K4 run together). K3 and K3q of this design are timed as
the wrapper's whole call and, on their own, the preparation and the flash
loop. ``--ablate`` adds, for every tree whose kernel has the design
they were written for and for each picked kernel, copies of it with one
part taken out (ABLATIONS). The conv pipeline (K1, K4, K6 and K2, in
trees that have ``conv_pipeline.cuh``): the products (what the loads, and
K4's pass, take alone) and the TMA loads (the products, the pass and the
epilogue alone, on whatever shared memory holds). K7 (wgmma on register-widened int8 for the video rows, split-K for
the text rows): the widening (the int8 bytes used as they are), the
products (wgmma and mma.sync replaced by a no-op that keeps their
operands live: loads, widening and epilogue alone), the video regime's
TMA loads, and the split-K reduce (the partial products alone). Their
outputs are garbage, their times say which part sets the pace. (Taking out
the epilogue is no such measure: ptxas then drops the products whose
accumulators nothing reads.) K3 / K3q's flash loop (attention_pipeline.cuh):
the products (the wgmma of Q K^T and P V replaced by operand fences: loads,
softmax and epilogue alone), the TMA and bulk loads (products, softmax
and epilogue on whatever shared memory holds), the skipping of key tiles
that hold no token (every tile loaded and multiplied), the one-MUFU exp2
(``exp2f`` in its place) and the exponentials (the argument used as it
is); an ablated flash loop runs on this tree's prepared scratch, so its
time is the flash loop's alone. K5 on the same loop (trees whose
``flash_attention.cuh`` is a policy of ``attention_pipeline.cuh``): the
products, the TMA loads (the key codes are still written), and the
skipping of key tiles whose 64 keys are all masked. K7 runs at every row of chip_smoke.py's phase
3 (3B and 7B, video M 7200 and 24,480, text M 58) and at the video rows
of the benchmark's image mix (7B, M 4096, 6912 and 14,400: IMAGE_ROWS),
each tree through its own entry points: this one through
ops/quant.py:launch (its regime of M), an older tree through its single
entry.
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

from .config import DiTConfig, dit_3b, dit_7b
from .models.dit.nadit import build_attn_plans, device_plans, mlp_hidden
from .ops import conv3d_kernel as k1
from .ops import cuda_lib
from .ops import flash_attention as k5
from .ops import fold_upsample_kernel as k2
from .ops import fused_window_attention as k3
from .ops import quant

CONV_SHAPES = ((512, 3, 180, 320), (256, 5, 360, 640), (128, 5, 720, 1280), (128, 5, 608, 1024), (256, 5, 304, 512))
K6_SHAPES = CONV_SHAPES[:3]
SOURCES = ("conv3d.cu", "conv3d_im2col.cu", "fold_upsample.cu", "w8a16_linear.cu", "window_attention.cu",
           "window_qk_prepare.cu", "flash_attention.cu", "gn_stats.cu")  # those a tree has
# K3 / K3q of a tree before the prepared design: one entry (csrc/window_attention.cu of that tree)
OLD_WINDOW_ATTENTION = ("seedvr2_window_attention", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                        + [ctypes.c_void_p])
# (model, latent frames x height x width, quant_qk) of K3 / K3q's rows: chip_smoke.py phase 3's
WINDOW_SHAPES = (("3b", (2, 45, 80), False), ("3b", (3, 68, 120), False), ("7b", (2, 45, 80), True))
FOLD_SHAPES = ((512, 2, 2, 2, 90, 160), (512, 2, 2, 3, 180, 320), (256, 3, 1, 7, 360, 640))  # C, kt, A, frames, H, W

# family -> (its kernels, header, a string of the design the ablations were written for)
ABLATED = {"conv": (("K1", "K4", "K6", "K2"), "conv_pipeline.cuh", "sm90::wgmma"),
           "K7": (("K7",), "w8a16_linear.cuh", "k16_rs_bf16("),
           "attn": (("K3", "K3q"), "attention_pipeline.cuh", "wgmma_m64n64k16_bf16_kmajor"),
           "flash": (("K5",), "flash_attention.cuh", '#include "attention_pipeline.cuh"')}
_TMA = (r"sm90::mbar_arrive_expect_tx\((\w+) \+ (\w+), [^;]*\);", r"sm90::mbar_arrive(\1 + \2);")
_TMA_LOADS = (r"sm90::tma_load_\dd\(.*?\);", ";")
_PRODUCTS = (("attention_pipeline.cuh", r"sm90::wgmma_m64n64k(16_bf16_kmajor|32_s8)\(s, .*?\);",
              "for (int e = 0; e < 32; ++e) sm90::fence_operand(s[e]);"),
             ("attention_pipeline.cuh", r"sm90::wgmma_m64n128k16_rs_bf16\(o, pa\[kk\], .*?\);",
              r'{ for (int e = 0; e < 64; ++e) sm90::fence_operand(o[e]); asm volatile("" ::"r"(pa[kk][0]), '
              r'"r"(pa[kk][1]), "r"(pa[kk][2]), "r"(pa[kk][3])); }'))
# name -> (family, (file, pattern, replacement) substitutions in its csrc
# copy, each of which must match at least once)
ABLATIONS = {
    "conv-products": ("conv", (("conv_pipeline.cuh", r"sm90::wgmma_m64n128k16_bf16\(.*?\);", ";"),)),
    "conv-loads": ("conv", (("conv_pipeline.cuh", *_TMA), ("conv_pipeline.cuh", *_TMA_LOADS))),
    "K7-widen": ("K7", (("w8a16_linear.cuh", r"(void widen_s8x4\(uint32_t q, uint32_t& lo, uint32_t& hi\) \{).*?\n\}",
                         r"\1\n  lo = hi = q;\n}"),)),
    "K7-products": ("K7", (("w8a16_linear.cuh", r"sm90::wgmma_m64n\d+k16_rs_bf16\(acc, cur\[kk\], .*?\);",
                            r'asm volatile("" ::"r"(cur[kk][0]), "r"(cur[kk][1]), "r"(cur[kk][2]), "r"(cur[kk][3]));'),
                           ("w8a16_linear.cuh", r"mma_bf16\(acc\[i\]\[j\], af, b\[j\]\[0\], b\[j\]\[1\]\);",
                            r'asm volatile("" ::"r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(b[j][0]), '
                            r'"r"(b[j][1]));'))),
    "K7-loads": ("K7", (("w8a16_linear.cuh", *_TMA), ("w8a16_linear.cuh", *_TMA_LOADS))),
    "K7-reduce": ("K7", (("w8a16_linear.cu", r"w8a16_splitk_reduce_kernel<<<.*?>>>\(.*?\);", ";"),)),
    "K3-products": ("attn", _PRODUCTS),
    "K3-loads": ("attn", (("attention_pipeline.cuh", *_TMA), ("window_attention.cuh", *_TMA_LOADS),
                          ("window_attention.cuh", r"sm90::bulk_load\(.*?\);", ";"))),
    "K3-skip": ("attn", (("window_attention.cuh", r"(int next_tile\(uint64_t live, int j\) const \{).*?\n  \}",
                          r"\1\n    return j + 1;\n  }"),)),
    "K3-fastexp": ("attn", (("attention_pipeline.cuh", r'asm\("ex2\.approx\.ftz\.f32 %0, %1;" : "=f"\(y\) : "f"\(x\)\);',
                             "y = exp2f(x);"),)),
    "K3-exp": ("attn", (("attention_pipeline.cuh", r'asm\("ex2\.approx\.ftz\.f32 %0, %1;" : "=f"\(y\) : "f"\(x\)\);',
                         "y = x;"),)),
    "K5-products": ("flash", _PRODUCTS),
    "K5-loads": ("flash", (("attention_pipeline.cuh", *_TMA), ("flash_attention.cuh", *_TMA_LOADS))),
    "K5-skip": ("flash", (("flash_attention.cuh", r"(uint64_t live_tiles\(const Item& it\) const \{).*?\n  \}",
                          r"\1\n    return all_tiles();\n  }"),)),
}


IMAGE_ROWS = (4096, 6912, 14400)  # DiT video rows of a 512x512, 576x768 / 768x576 and 720x1280 image upscaled 2x


def int8_linear_shapes(cfg: DiTConfig) -> list:
    """(name, K, N, bias) of the four kinds of int8 block linear of a DiT
    config, unsplit: qkv, attention out, MLP in (and gate), MLP out (K7's
    rows here and in chip_smoke.py's phase 3)."""
    D, inner, hidden, mlp_bias = cfg.vid_dim, cfg.inner_dim, mlp_hidden(cfg), cfg.mlp_type != "swiglu"
    return [("qkv", D, 3 * inner, cfg.qk_bias), ("out", inner, D, True),
            ("proj_in" + ("/proj_in_gate" if not mlp_bias else ""), D, hidden, mlp_bias),
            ("proj_out", hidden, D, mlp_bias)]


def flash_shapes(dev) -> list:
    """(name, B, S, H, kv_valid) of K5's rows: the 7B unfused window
    attention at 720p (chip_smoke.py phase 3), B = nW windows of S = mL + Lt
    rows, keys valid = [window validity | all text]."""
    cfg, Lt = dit_7b(), 58
    out = []
    for which, dp in zip(("plain", "shifted"), device_plans(build_attn_plans(cfg, (2, 45, 80), Lt), cfg.head_dim, dev)):
        nW, mL = dp.valid.shape
        kv_valid = torch.cat([dp.valid, torch.ones(nW, Lt, dtype=torch.bool, device=dev)], dim=1).contiguous()
        out.append((f"7b {which}", nW, mL + Lt, cfg.heads, kv_valid))
    return out


def tables_fp64(x_ext: torch.Tensor, gw: torch.Tensor, gb: torch.Tensor, groups: int, eps: float = 1e-6):
    """K4's tables (scale, shift) [B, T, C] in fp64: the reference the
    kernel and the plain version are measured against."""
    B, T, H, W, C = x_ext.shape
    xd = x_ext.double().reshape(B, T, H * W, groups, C // groups)
    var, mean = torch.var_mean(xd, dim=(2, 4), correction=0)
    rstd = (var + eps).rsqrt().repeat_interleave(C // groups, dim=-1)
    scale = rstd * gw.double()
    return scale, gb.double() - mean.repeat_interleave(C // groups, dim=-1) * scale


def max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref| (a shift near 0 in one channel would make
    an elementwise ratio meaningless)."""
    return float((got.double() - ref).abs().max() / ref.abs().max())


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per value, how many bf16 codes apart two bf16 tensors are, the codes
    taken in value order (-0 and +0 alike)."""

    def key(t):
        k = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)

    return (key(a) - key(b)).abs()


# fp32 rounding of a GroupNorm's summands (|x * scale| + |shift|), in units of
# their magnitude: 8 ulps (fp32 tables, or a mean and rstd in another order,
# move a normalised value by a few)
GN_ABS = 2.0**-20


def gn_codes(pre: torch.Tensor, pre_ref: torch.Tensor, mag: torch.Tensor, out=None, out_ref=None) -> dict:
    """Where two per-frame GroupNorm passes (bf16 results) part: ``pre`` the
    normalised values, ``out`` (optional) those after the SiLU, ``mag`` |x *
    scale| + |shift| of each value in fp32. ``share``: the share of output
    codes that differ (of ``pre`` without ``out``); ``far``: normalised codes
    more than one step apart where they also differ by more than the fp32
    rounding of the summands (GN_ABS * mag: a value near its group's mean
    cancels, and near 0 bf16 codes are dense), plus SiLU outputs more than
    one step apart where the normalised codes agree. A pass that keeps the
    JAX package's op order has ``far`` 0."""
    steps = bf16_steps(pre, pre_ref)
    gap = (pre.float() - pre_ref.float()).abs()
    far = int(((steps > 1) & (gap > GN_ABS * mag)).sum())
    if out is None:
        return {"share": float((steps > 0).float().mean()), "far": far}
    out_steps = bf16_steps(out, out_ref)
    far += int(((out_steps > 1) & (steps == 0)).sum())
    return {"share": float((out_steps > 0).float().mean()), "pre_share": float((steps > 0).float().mean()),
            "far": far}


def ablated(csrc: Path, out: Path, kernels) -> dict:
    """{name: (family, csrc copy)} with each of ABLATIONS of a family with a
    kernel in ``kernels`` applied, where its header in csrc has the design
    of ABLATED."""
    trees = {}
    for name, (family, subs) in ABLATIONS.items():
        members, header, design = ABLATED[family]
        if not set(members) & set(kernels) or not (csrc / header).exists() or design not in (csrc / header).read_text():
            continue
        tree = out / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(csrc, tree)
        for file, pat, rep in subs:
            text, n = re.subn(pat, rep, (tree / file).read_text(), flags=re.S)
            if n == 0:
                raise RuntimeError(f"ablation {name}: {pat!r} matches nothing in {csrc / file}")
            (tree / file).write_text(text)
        trees[name] = (family, tree)
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
    for fn, args in (*cuda_lib._SIGNATURES.items(), OLD_WINDOW_ATTENTION):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    return lib, ptxas_report(p.stdout + p.stderr)


def ptxas_report(log: str) -> str:
    """ptxas's spill and register lines of the conv kernels, K7 and K3 / K3q, each after its kernel's name."""
    return "".join(f"\n  {name}: {line}" for name, line in cuda_lib.ptxas_lines(log)
                   if any(k in name for k in ("conv", "fold", "w8a16", "flash_kernel", "qk_prepare", "WindowPolicy",
                                              "attention_kernel", "gn_stats")))


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
    ap.add_argument("--kernels", default="K1,K4,K6,K2,K7,K3,K3q,K5,K8",
                    help="comma-separated subset of K1,K4,K6,K2,K7,K3,K3q,K5,K8")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the conv kernels, K7, K3 / K3q's flash loop and K5 with one part taken out")
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
    ablation_of = {}  # an ablated build's name -> its family
    if args.ablate:
        for i, (name, csrc) in enumerate([("this", cuda_lib.CSRC), *others.items()]):
            for k, (family, tree) in ablated(csrc, work / f"ablate{i}", kernels).items():
                others[f"{name} {k}"], ablation_of[f"{name} {k}"] = tree, family
    with ThreadPoolExecutor(len(others) or 1) as pool:
        outs = [work / str(i) for i in range(len(others))]
        for d, (lib, report) in zip(others, pool.map(build_other, others.values(), outs)):
            libs[d] = lib
            print(f"{d}:", report, flush=True)
    trees = {n: L for n, L in libs.items() if n not in ablation_of}
    conv_libs = {n: L for n, L in libs.items() if ablation_of.get(n, "conv") == "conv"}  # timed, ablated too
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
            for n, L in conv_libs.items():
                calls[f"{n} K1"], calls[f"{n} K4"] = (lambda L=L: run(L, False)), (lambda L=L: run(L, True))
            del ref4
        if k6:
            errs = " ".join(f"{n} {rel_l2(run6(L), ref1):.2e}" for n, L in trees.items())
            print(f"K6 c{c} {T}x{H}x{W}: rel L2 {errs}", flush=True)
            calls.update({f"{n} K6": (lambda L=L: run6(L)) for n, L in conv_libs.items()})
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
        calls.update({n: (lambda L=L: run2(L)) for n, L in conv_libs.items()})
        timed_rounds(calls, args.rounds)
        del x, K, y, ref, xc, Ko

    libs7 = {n: L for n, L in libs.items() if ablation_of.get(n, "K7") == "K7" and hasattr(L, "seedvr2_w8a16_linear")}
    k7_rows = [(cfg.variant, name, M, K, N) for cfg in (dit_3b(), dit_7b()) for M in (7200, 58)
               for name, K, N, _ in int8_linear_shapes(cfg)]
    k7_rows.append(("3b", "qkv", 24480, *int8_linear_shapes(dit_3b())[0][1:3]))
    k7_rows += [("7b", name, M, K, N) for M in IMAGE_ROWS for name, K, N, _ in int8_linear_shapes(dit_7b())]
    for variant, name, M, K, N in k7_rows if "K7" in kernels else ():
        q = quant.quantize_linear(torch.randn(K, N, generator=g, device=dev) * K**-0.5)
        w_q, w_s, w_deq = q["w_q"].t().contiguous(), q["w_s"], quant.dequantize_weight(q)
        x, y = randn(M, K), torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        ref = quant.linear_apply_plain(x, w_q, w_s)

        def run7(lib):
            if hasattr(lib, "seedvr2_w8a16_linear_splitk"):
                quant.launch(lib, x, w_q, w_s, None, y)
            else:
                cuda_lib.check(lib.seedvr2_w8a16_linear(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), None,
                                                         y.data_ptr(), M, N, K, stream()), "w8a16_linear")
            return y

        errs = " ".join(f"{n} {rel_l2(run7(L), ref):.2e}" for n, L in libs7.items())
        print(f"K7 {variant} {name} M{M} K{K} N{N} ({quant.regime(M)}, {2 * M * N * K / 1e9:.1f} GFLOP): rel L2 {errs}",
              flush=True)
        calls = {"cublas": lambda: x @ w_deq}
        calls.update({f"{n} K7": (lambda L=L: run7(L)) for n, L in libs7.items()})
        timed_rounds(calls, args.rounds)
        del q, w_q, w_s, w_deq, x, y, ref

    attn_libs = {n: L for n, L in libs.items() if ablation_of.get(n) == "attn"}
    for variant, thw, quant_qk in WINDOW_SHAPES:
        kid = "K3q" if quant_qk else "K3"
        if kid not in kernels:
            continue
        cfg = dit_3b() if variant == "3b" else dit_7b()
        H, D, Lt = cfg.heads, cfg.head_dim, 58
        for which, dp in zip(("plain", "shifted"), device_plans(build_attn_plans(cfg, thw, Lt), D, dev)):
            nW, S = dp.valid.shape
            vqkv, tqkv = randn(1, 3, H, nW, S, D), randn(1, 3, H, Lt, D)
            norms = 1 + 0.1 * torch.randn(4, D, generator=g, device=dev)
            wargs = (vqkv, tqkv, dp.vid_cos, dp.vid_sin, dp.txt_cos, dp.txt_sin, dp.valid, dp.rope_txt, norms, True,
                     cfg.norm_eps)
            ref = k3.fused_window_attention_plain(*wargs, quant_qk=quant_qk)
            prep = k3.qk_prepare(here, *wargs, quant_qk)

            def run3(lib):
                if hasattr(lib, "seedvr2_window_flash"):
                    return k3.window_flash(lib, vqkv, tqkv, k3.qk_prepare(lib, *wargs, quant_qk), quant_qk)
                ovid = torch.empty((1, H, nW, S, D), dtype=torch.bfloat16, device=dev)
                otxt = torch.empty((1, H, nW, Lt, D), dtype=torch.bfloat16, device=dev)
                cuda_lib.check(lib.seedvr2_window_attention(
                    vqkv.data_ptr(), tqkv.data_ptr(), *(t.data_ptr() for t in wargs[2:7]), norms.data_ptr(),
                    ovid.data_ptr(), otxt.data_ptr(), 1, H, nW, S, Lt, int(dp.rope_txt), 1, int(quant_qk),
                    cfg.norm_eps, D**-0.5, stream()), "window_attention")
                return ovid, otxt

            errs = " ".join(f"{n} {max(rel_l2(a, b) for a, b in zip(run3(L), ref)):.2e}" for n, L in trees.items())
            print(f"{kid} {variant} {thw} {which} H{H} nW{nW} S{S} Lt{Lt}: rel L2 {errs}", flush=True)
            calls = {}
            if not quant_qk:
                q, k, v = (torch.cat([vqkv[0, i].permute(1, 0, 2, 3), tqkv[0, i][None].expand(nW, H, Lt, D)], dim=2)
                           for i in range(3))
                mask = torch.cat([dp.valid, torch.ones(nW, Lt, dtype=torch.bool, device=dev)], dim=1)[:, None, None]
                calls["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            calls.update({f"{n} {kid}": (lambda L=L: run3(L)) for n, L in trees.items()})
            calls["this prep"] = lambda: k3.qk_prepare(here, *wargs, quant_qk)
            calls["this flash"] = lambda: k3.window_flash(here, vqkv, tqkv, prep, quant_qk)
            calls.update({f"{n} flash": (lambda L=L: k3.window_flash(L, vqkv, tqkv, prep, quant_qk))
                          for n, L in attn_libs.items()})
            timed_rounds(calls, args.rounds)
            del vqkv, tqkv, ref, prep, calls

    flash_libs = {n: L for n, L in libs.items() if ablation_of.get(n, "flash") == "flash"}
    for name, B, S, H, kv_valid in flash_shapes(dev) if "K5" in kernels else ():
        D = k5.HEAD_DIM
        q, k, v = (randn(B, S, H, D) for _ in range(3))
        o = torch.empty_like(q)
        ref = k5.flash_attention_plain(q, k, v, kv_valid)

        def run5(lib):
            cuda_lib.check(lib.seedvr2_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
                                                       None, o.data_ptr(), B, S, H, k5.padded_len(S) - S, D**-0.5,
                                                       stream()), "flash_attention")
            return o

        errs = " ".join(f"{n} {rel_l2(run5(L), ref):.2e}" for n, L in trees.items())
        live = int(kv_valid.view(B, -1).any(1).sum())
        print(f"K5 {name} B{B} S{S} H{H} ({int(kv_valid.sum())} valid keys, {live} rows with one): rel L2 {errs}",
              flush=True)
        qt, kt, vt, mask = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_valid[:, None, None]
        calls = {"sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)}
        calls.update({f"{n} K5": (lambda L=L: run5(L)) for n, L in flash_libs.items()})
        timed_rounds(calls, args.rounds)
        del q, k, v, o, ref, calls

    for c, T, H, W in CONV_SHAPES if "K8" in kernels else ():
        x = randn(1, T + 2, H, W, c)
        gw, gb = 1 + 0.2 * torch.randn(c, generator=g, device=dev), 0.3 * torch.randn(c, generator=g, device=dev)
        ref = tables_fp64(x, gw, gb, 32)
        got = {"plain tables": k1.gn_silu_tables_plain(x, gw, gb, 32)}
        k8_libs = {n: L for n, L in trees.items() if hasattr(L, "seedvr2_gn_stats")}
        got.update({f"{n} K8": k1.gn_stats_launch(L, x, gw, gb, 32) for n, L in k8_libs.items()})
        errs = " ".join(f"{n} {max_rel(a[0], ref[0]):.2e} / {max_rel(a[1], ref[1]):.2e}" for n, a in got.items())
        print(f"K8 c{c} {T + 2}x{H}x{W} ({x.numel() * 2 / 1e6:.0f} MB): max rel err of scale / shift vs fp64 {errs}",
              flush=True)
        xg = x.view(1, T + 2, H * W, 32, c // 32)
        calls = {"var_mean": lambda: torch.var_mean(xg, dim=(2, 4), correction=0),
                 "plain tables": lambda: k1.gn_silu_tables_plain(x, gw, gb, 32)}
        calls.update({f"{n} K8": (lambda L=L: k1.gn_stats_launch(L, x, gw, gb, 32)) for n, L in k8_libs.items()})
        timed_rounds(calls, args.rounds)
        del x, xg, ref, got, calls


if __name__ == "__main__":
    main()
