"""The port's kernel bench: every hand-written kernel at the shapes of the
main paths, on the card, against its plain version and the nearest library
call, and (``--against``) against the same kernel built from other source
trees.

    python -m seedvr2_tpu_torch.conv_ab [--kernels K1,K4,...] [--against DIR ...] [--ablate] [--rounds 4]

The kernels (``--kernels``, all by default): K1 and K4 (the VAE's resnet
conv, without and with its GroupNorm + SiLU prologue; they run together),
K8 (K4's tables), K9 (the GroupNorm pass on them), K2, K3 and K3q (the
wrapper's whole call; then the preparation and the flash loop alone), K5,
K11, K10 and K7. A row is one kernel at one shape. This tree's kernel
runs through the program's wrapper (ops/), which counts its launch: its
rel L2 against the plain version must be at most REL_BOUND and finite, a
second call must give the same bits, and the bench's own launch of the C
entry (what it times) the wrapper's bits, or the bench raises (K8 also
holds its tables within 1e-6 of fp64, K9 its bf16 codes to the plain
version's and its route to the plain route's, as
tests/test_torch_kernels_gpu.py does). It prints each build's rel L2
against the plain version. Then ``--rounds`` rounds of ms per
call (CUDA events over 10 calls after a warm-up) of the library call and
of each build, in an order that reverses every other round (a card near its
power limit runs slower after a heavy call, so a fixed order would favour
one side), and last a line "=": this tree's rel L2, its ms and the library
call's (medians of the rounds), the plain version's ms (3 calls) and the
bound, max(bytes / HBM_BYTES_PER_S, operations / PEAK_OPS of their type),
with the kernel's share of it. ``run`` returns the rows as dicts
(chip_smoke.py's phase 3 runs them on this tree, one round, and adds each
row's launch count from its driven runs: ``path`` names the main path that
gives the row's shape, "720p" the 5-frame 640x360 -> 1280x720 batch,
"long_clip" the 15-frame 1080p clip, None no driven run).

Each DIR is another tree's ``csrc/`` (the parent commit's, for example,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Its ``*.cu`` files are compiled with this tree's ``nvcc`` flags into a
library of their own and called through the same C entry points
(``ops/cuda_lib.py:_SIGNATURES``); a row leaves out a build that lacks
its kernel's entry (an older tree, or one that split or renamed it), and
prints that it did. ``--ablate``
adds, for every tree whose kernel has the design they were written for and
for each picked kernel, copies of it with one part taken out (ABLATIONS).
The conv pipeline (K1, K4, K2): the products (what the loads, and K4's
pass, take alone) and the TMA loads (the products, the pass and the
epilogue alone, on whatever shared memory holds). K7 (wgmma on
register-widened int8 for the video rows, split-K for the text rows): the
widening (the int8 bytes used as they are), the products (wgmma and
mma.sync replaced by a no-op that keeps their operands live: loads,
widening and epilogue alone), the video regime's TMA loads, and the
split-K reduce (the partial products alone). Their outputs are garbage,
their times say which part sets the pace. (Taking out the epilogue is no
such measure: ptxas then drops the products whose accumulators nothing
reads.) K3 / K3q's flash loop (attention_pipeline.cuh): the products (the
wgmma of Q K^T and P V replaced by operand fences: loads, softmax and
epilogue alone), the TMA and bulk loads (products, softmax and epilogue on
whatever shared memory holds), the skipping of key tiles that hold no
token (every tile loaded and multiplied), the one-MUFU exp2 (``exp2f`` in
its place) and the exponentials (the argument used as it is); an ablated
flash loop runs on this tree's prepared scratch, so its time is the flash
loop's alone. K5 on the same loop: the products, the TMA loads (the key
codes are still written), and the skipping of key tiles whose 64 keys are
all masked. K7 runs at the 3B and 7B linears' video (M 7200, and 24,480
for the 3B qkv of the 1080p long clip) and text rows (M 58), and at the
video rows of the benchmark's image mix (7B, M 4096, 6912 and 14,400:
IMAGE_ROWS), each tree through ops/quant.py:launch (the regime of M).
Prints the card and ptxas's register and spill report of every build
first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
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
from .ops import mid_attention as k10
from .ops import normalization as norm
from .ops import quant
from .ops import window_prepare as k11

KERNELS = ("K1", "K4", "K8", "K9", "K2", "K3", "K3q", "K5", "K11", "K10", "K7")
REL_BOUND = 1e-2  # ||kernel - plain||_2 / ||plain||_2: the kernels round their outputs to bf16 (~4e-3)
# NVIDIA H100 SXM published peaks (dense, at the 700 W limit)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12

# The last item of a shape is its row's path (see the docstring).
# (C, T, H, W) of K1, K4 and K8: the resnet convs of the 720p decode (latent 2x90x160 -> 5x720x1280), then the
# c128 and c256 convs of one 608 x 1024 tile of the long clip's tiled 1080p decode (the 1080p frame padded to
# 1088 x 1920 is a 136 x 240 latent, cut by 1024 px tiles with 128 px overlap into 76 x 128 latent tiles)
CONV_SHAPES = (((512, 3, 180, 320), "720p"), ((256, 5, 360, 640), "720p"), ((128, 5, 720, 1280), "720p"),
               ((128, 5, 608, 1024), "long_clip"), ((256, 5, 304, 512), "long_clip"))
# (C, kt, A, frames, H, W) of K2: the 720p decode's three upsamples (path "720p")
FOLD_SHAPES = ((512, 2, 2, 2, 90, 160), (512, 2, 2, 3, 180, 320), (256, 3, 1, 7, 360, 640))
# (model, patched latent frames x height x width, quant_qk, path) of K3 / K3q: the 720p batch, and the long clip's
# 1080p batch of 9 frames (1080x1920 padded to 1088x1920, /8 by the VAE, /2 by the patch; 9 frames -> 3 latents)
WINDOW_SHAPES = (("3b", (2, 45, 80), False, "720p"), ("3b", (3, 68, 120), False, "long_clip"),
                 ("7b", (2, 45, 80), True, "720p"))
# K9's (x [1, T, H, W, C], SiLU, which GroupNorm, path): the 720p resnets' extended inputs (decoder; the encoder's are
# the same shapes), the decoder's norm_out at full resolution, the encoder's norm_out and the mid attention's
# GroupNorm at 1/8; the long clip's decode tile (norm_out of its first slice, and a c256 resnet input)
K9_SHAPES = (((5, 180, 320, 512), True, "resnet c512 x_ext", "720p"),
             ((7, 360, 640, 256), True, "resnet c256 x_ext", "720p"),
             ((7, 720, 1280, 128), True, "resnet c128 x_ext", "720p"),
             ((5, 720, 1280, 128), True, "decoder norm_out", "720p"),
             ((2, 90, 160, 512), True, "encoder norm_out", "720p"), ((2, 90, 160, 512), False, "mid attention", "720p"),
             ((5, 608, 1024, 128), True, "decode tile norm_out", "long_clip"),
             ((7, 304, 512, 256), True, "decode tile c256 x_ext", "long_clip"))
# K10's (frames, pixels a frame, C, which call, path): a 720p batch's two 90 x 160 latent frames, the first temporal
# slice of the long clip's decode tile (two 76 x 128), a video1080 batch's two 135 x 240, a 720x1280 image's
# one 180 x 320 at 2x, and the small config's width at a ragged n (64 query tiles and one row)
K10_SHAPES = ((2, 14400, 512, "720p batch", "720p"), (2, 9728, 512, "long clip decode tile, first slice", "long_clip"),
              (2, 32400, 512, "video1080 batch", None), (1, 57600, 512, "image2x 720x1280", None),
              (1, 4097, 256, "small config, ragged n", None))
# K11's (patched latent, plain 0 or shifted 1, which call, path) at the 7B's plans: the 720p batch, a video1080 batch's
# latent (5 frames -> 2 latents) in both plans, and a 720x1280 image's at 2x (one 90 x 160 latent)
K11_SHAPES = (((2, 45, 80), 0, "720p batch", "720p"), ((2, 68, 120), 0, "video1080 batch", None),
              ((2, 68, 120), 1, "video1080 batch", None), ((1, 90, 160), 0, "image2x 720x1280", None))
IMAGE_ROWS = (4096, 6912, 14400)  # DiT video rows of a 512x512, 576x768 / 768x576 and 720x1280 image upscaled 2x

# family -> (its kernels, header, a string of the design the ablations were written for)
ABLATED = {"conv": (("K1", "K4", "K2"), "conv_pipeline.cuh", "sm90::wgmma"),
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


def int8_linear_shapes(cfg: DiTConfig) -> list:
    """(name, K, N, bias) of the four kinds of int8 block linear of a DiT
    config, unsplit: qkv, attention out, MLP in (and gate), MLP out (K7's
    rows)."""
    D, inner, hidden, mlp_bias = cfg.vid_dim, cfg.inner_dim, mlp_hidden(cfg), cfg.mlp_type != "swiglu"
    return [("qkv", D, 3 * inner, cfg.qk_bias), ("out", inner, D, True),
            ("proj_in" + ("/proj_in_gate" if not mlp_bias else ""), D, hidden, mlp_bias),
            ("proj_out", hidden, D, mlp_bias)]


def flash_shapes(dev) -> list:
    """(name, B, S, H, kv_valid) of K5's rows: the 7B unfused window
    attention at 720p, B = nW windows of S = mL + Lt rows, keys valid =
    [window validity | all text]."""
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: dict):
    """Least time on the card: the larger of the bytes over the memory rate
    and the operations over the peak rate of their type (ms, and which)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items()) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    """(library, ptxas report) of csrc's ``*.cu``."""
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libconv_ab.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
           "-o", str(so), *(str(f) for f in sorted(csrc.glob("*.cu")))]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{p.stdout}{p.stderr}")
    return bind(ctypes.CDLL(str(so))), ptxas_report(p.stdout + p.stderr)


def bind(lib):
    """Types the C entries of ``_SIGNATURES`` that ``lib`` exports; a tree
    may lack some, and the rows of their kernels leave it out."""
    for fn, args in cuda_lib._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def ptxas_report(log: str) -> str:
    """ptxas's spill and register lines of every kernel, each after its kernel's name."""
    return "".join(f"\n  {name}: {line}" for name, line in cuda_lib.ptxas_lines(log))


def _tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _rel(got, ref) -> float:
    """The largest rel L2 over a kernel's outputs."""
    return max(float((a.float() - b.float()).norm() / b.float().norm()) for a, b in zip(_tuple(got), _tuple(ref)))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class Bench:
    """The builds (``libs``: "this", each DIR, each ablated copy), the
    rows' shared settings, and the rows so far (``rows``)."""

    def __init__(self, libs: dict, ablation_of: dict, rounds: int, dev, kernels=KERNELS):
        self.libs, self.ablation_of, self.rounds, self.dev, self.kernels = libs, ablation_of, rounds, dev, kernels
        self.g = torch.Generator(device=dev).manual_seed(0)
        self.rows = []

    def family(self, family=None, entries=()) -> dict:
        """The trees, and the copies ablated in ``family`` (None: the trees
        alone), that export every C entry of ``entries``."""
        return {n: L for n, L in self.libs.items()
                if self.ablation_of.get(n, family) == family and all(hasattr(L, e) for e in entries)}

    def randn(self, *shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=self.g, device=self.dev) * scale).to(dtype)

    def row(self, label, kernel, launch, entries, ref, plain, moved, ops, library=None, family=None, extra=None,
            path=None, **info) -> dict:
        """One kernel at one shape; its kernel id is the label's first word.
        ``kernel()`` runs this tree's kernel through the program's wrapper;
        ``launch(lib)`` runs it once from a build through its C ``entries``
        and returns its output(s); ``ref`` is the plain version's output,
        ``plain`` a call of it; ``library`` (name, call); the builds of
        ``family`` are timed, and ``extra``, more calls. ``path`` and
        ``info`` go into the row as they are."""
        first = tuple(t.clone() for t in _tuple(kernel()))
        builds = self.family(None, entries)
        errs = {"this": _rel(first, ref), **{n: _rel(launch(L), ref) for n, L in builds.items() if n != "this"}}
        lacking = [n for n in self.family() if n not in builds]
        print(f"{label}: rel L2 vs plain " + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + (f" (left out, no {'/'.join(entries)}: {', '.join(lacking)})" if lacking else ""), flush=True)
        if not (errs["this"] <= REL_BOUND and all(bool(torch.isfinite(t).all()) for t in first)):
            raise RuntimeError(f"{label}: kernel disagrees with its plain version (rel L2 {errs['this']:.3e})")
        if not all(torch.equal(a, b) for a, b in zip(first, _tuple(kernel()))):
            raise RuntimeError(f"{label}: two launches on the same inputs differ")
        if not all(torch.equal(a, b) for a, b in zip(first, _tuple(launch(self.libs["this"])))):
            raise RuntimeError(f"{label}: the bench's launch of {'/'.join(entries)} differs from the wrapper's")
        del first
        calls = {library[0]: library[1]} if library else {}
        calls.update({n: (lambda L=L: launch(L)) for n, L in self.family(family, entries).items()})
        calls.update(extra or {})
        ms = {n: [] for n in calls}
        for r in range(self.rounds):
            for n in list(calls) if r % 2 == 0 else list(calls)[::-1]:
                ms[n].append(cuda_ms(calls[n]))
            print("   " + " | ".join(f"{n} {ms[n][-1]:.3f}" for n in calls), flush=True)
        plain_ms, (bound_ms, by) = cuda_ms(plain, 3), bound(moved, ops)
        this = statistics.median(ms["this"])
        lib_ms = statistics.median(ms[library[0]]) if library else None
        lib = f", {library[0]} {lib_ms:.3f} ms" if library else ""
        print(f"  = {label}: rel L2 {errs['this']:.2e}, {this:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound "
              f"{bound_ms:.4f} ms ({by}), {bound_ms / this:.1%} of it", flush=True)
        row = {"name": label, "kernel": label.split()[0], "path": path, **info, "launches": None,
               "rel_l2": errs["this"], "ms": this, "plain_ms": plain_ms, "library": library and library[0],
               "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": by, "share": bound_ms / this}
        self.rows.append(row)
        return row


def conv_rows(b: Bench):
    """K1 and K4 at CONV_SHAPES; K4's tables from K8 (its own row times
    them), its library call the chain it fuses."""
    for (c, T, H, W), path in CONV_SHAPES:
        x, w = b.randn(1, T + 2, H, W, c), b.randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5)
        bias = b.randn(c, dtype=torch.float32)
        gw, gb = 1 + b.randn(c, scale=0.2, dtype=torch.float32), b.randn(c, scale=0.3, dtype=torch.float32)
        sc, sf = k1.gn_silu_tables(x, gw, gb, 32)
        y = torch.empty((1, T, H, W, c), dtype=torch.bfloat16, device=b.dev)
        xc, wo = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
        moved, ops = nbytes(x, w, bias) + nbytes(y), {"bf16": 2 * T * H * W * 27 * c * c}

        def run(lib, gn):
            cuda_lib.check(lib.seedvr2_conv3d_3x3x3(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                                     sc.data_ptr() if gn else None, sf.data_ptr() if gn else None,
                                                     y.data_ptr(), 1, T, H, W, c, c, _stream()), "conv3d_3x3x3")
            return y

        def chain():
            h = x.permute(0, 1, 4, 2, 3).reshape(T + 2, c, H, W)  # per-frame GroupNorm on NCHW frames
            h = F.silu(F.group_norm(h, 32, gw.bfloat16(), gb.bfloat16(), eps=1e-6))
            return F.conv3d(h.reshape(1, T + 2, c, H, W).transpose(1, 2), wo, bias.bfloat16(), padding=(0, 1, 1))

        shape, entry = f"c{c} {T}x{H}x{W}", ("seedvr2_conv3d_3x3x3",)
        b.row(f"K1 {shape}", lambda: k1.conv3d_3x3x3(x, w, bias), lambda L: run(L, False), entry,
              k1.conv3d_3x3x3_plain(x, w, bias), lambda: k1.conv3d_3x3x3_plain(x, w, bias), moved, ops,
              ("cudnn", lambda: F.conv3d(xc, wo, bias.bfloat16(), padding=(0, 1, 1))), "conv", path=path)
        b.row(f"K4 {shape} (tables not timed)", lambda: k1.conv3d_3x3x3(x, w, bias, sc, sf), lambda L: run(L, True),
              entry, k1.conv3d_3x3x3_plain(x, w, bias, sc, sf), lambda: k1.conv3d_3x3x3_plain(x, w, bias, sc, sf),
              moved + nbytes(sc, sf), ops, ("gn+silu+cudnn", chain), "conv", path=path)
        del x, w, sc, sf, y, xc, wo


def tables_rows(b: Bench):
    """K8 on K4's inputs: against the plain tables, each within 1e-6 of
    fp64 (max |err| / max |ref| of scale and of shift); the library call
    torch.var_mean over the grouped bf16 view (the statistics alone)."""
    entry = ("seedvr2_gn_stats",)
    for (c, T, H, W), path in CONV_SHAPES:
        x = b.randn(1, T + 2, H, W, c)
        gw, gb = 1 + b.randn(c, scale=0.2, dtype=torch.float32), b.randn(c, scale=0.3, dtype=torch.float32)
        ref = tables_fp64(x, gw, gb, 32)
        got = {"plain": k1.gn_silu_tables_plain(x, gw, gb, 32)}
        got["this"] = k1.gn_silu_tables(x, gw, gb, 32)
        got.update({n: k1.gn_stats_launch(L, x, gw, gb, 32) for n, L in b.family(None, entry).items() if n != "this"})
        errs = {n: [max_rel(a, r) for a, r in zip(t, ref)] for n, t in got.items()}
        print(f"K8 c{c} {T + 2}x{H}x{W}: max rel err of scale / shift vs fp64 "
              + " ".join(f"{n} {e[0]:.2e} / {e[1]:.2e}" for n, e in errs.items()), flush=True)
        if max(errs["this"]) > 1e-6:
            raise RuntimeError(f"K8 c{c} {T + 2}x{H}x{W}: scale / shift {errs['this']} from fp64, over 1e-6")
        xg = x.view(1, T + 2, H * W, 32, c // 32)
        b.row(f"K8 c{c} {T + 2}x{H}x{W}", lambda: k1.gn_silu_tables(x, gw, gb, 32),
              lambda L: k1.gn_stats_launch(L, x, gw, gb, 32), entry, got["plain"],
              lambda: k1.gn_silu_tables_plain(x, gw, gb, 32), nbytes(x, gw, gb) + nbytes(*got["plain"]), {},
              ("var_mean", lambda: torch.var_mean(xg, dim=(2, 4), correction=0)), path=path)
        del x, xg, ref, got


def gn_apply_rows(b: Bench):
    """K9 on K8's tables of random bf16 x with the VAE's bf16 norm weights:
    against its plain version without the SiLU the same bits, with it no
    code more than one step away and at most 1e-3 of them moved; the VAE's
    call (K8 then K9) against the plain route it replaces (gn_codes: no far
    code, at most 1e-3 moved). The library call is a chain: a
    channels-first copy, F.group_norm, F.silu."""
    for (T, H, W, c), silu, what, path in K9_SHAPES:
        x = b.randn(1, T, H, W, c)
        gw, gb = 1 + b.randn(c, scale=0.2), b.randn(c, scale=0.3)
        scale, shift = k1.gn_silu_tables(x, gw, gb, 32)
        y = torch.empty_like(x)
        ppb, steps = norm.gn_apply_geometry(c)
        label = f"K9 {'gn_silu' if silu else 'group_norm'} c{c} {T}x{H}x{W} ({what})"

        def run(lib):
            cuda_lib.check(lib.seedvr2_gn_apply(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(), T,
                                                H * W, c, ppb, steps, int(silu), _stream()), "gn_apply")
            return y

        ref = norm.gn_apply_plain(x, scale, shift, silu)
        moved_codes = bf16_steps(norm.gn_apply(x, scale, shift, silu), ref)
        share, most = float((moved_codes > 0).float().mean()), int(moved_codes.max())
        mag = (x.float() * scale[:, :, None, None, :]).abs() + shift[:, :, None, None, :].abs()
        pair = [(norm.group_norm_frames(x, gw, gb, 32, s), norm.group_norm_frames_plain(x, gw, gb, 32, s))
                for s in ((False, True) if silu else (False,))]
        route = gn_codes(*pair[0], mag, *(pair[1] if silu else ()))
        del moved_codes, mag, pair
        print(f"{label}: {share:.2e} of the codes moved from the plain version (up to {most} steps); K8 + K9 "
              f"against the plain route {route}", flush=True)
        if most > (1 if silu else 0) or share > 1e-3 or route["far"] or route["share"] > 1e-3:
            raise RuntimeError(f"{label}: codes moved from the plain version or the plain route")

        def chain():
            h = F.group_norm(x.permute(0, 1, 4, 2, 3).reshape(T, c, H, W), 32, gw, gb, eps=1e-6)
            return F.silu(h) if silu else h

        b.row(label, lambda: norm.gn_apply(x, scale, shift, silu), run, ("seedvr2_gn_apply",), ref,
              lambda: norm.gn_apply_plain(x, scale, shift, silu), 2 * nbytes(x) + nbytes(scale, shift), {},
              ("gn" + ("+silu" if silu else ""), chain), path=path)
        del x, scale, shift, y, ref


def fold_rows(b: Bench):
    """K2 at the decoder's three upsamples at 720p; the library call is
    cuDNN on the folded weight (no bias table, no depth-to-space)."""
    for c, kt, A, frames, H, W in FOLD_SHAPES:
        x, K = b.randn(1, frames, H, W, c), b.randn(kt, 2, 2, c, A * 4 * c, scale=(kt * 4 * c) ** -0.5)
        bt, bc = b.randn(2, 2, A * 4 * c, dtype=torch.float32), b.randn(c, dtype=torch.float32)
        Tp = frames - kt + 1
        y = torch.empty((1, Tp * A, 2 * H, 2 * W, c), dtype=torch.bfloat16, device=b.dev)
        xc, Ko = x.permute(0, 4, 1, 2, 3), K.permute(4, 3, 0, 1, 2).contiguous()

        def run(lib):
            cuda_lib.check(lib.seedvr2_fold_upsample(x.data_ptr(), K.data_ptr(), bt.data_ptr(), bc.data_ptr(),
                                                      y.data_ptr(), 1, Tp, kt, A, H, W, c, _stream()), "fold_upsample")
            return y

        b.row(f"K2 c{c} kt{kt} A{A} {frames}x{H}x{W}", lambda: k2.fold_upsample_conv(x, K, bt, bc, A), run,
              ("seedvr2_fold_upsample",), k2.fold_upsample_conv_plain(x, K, bt, bc, A),
              lambda: k2.fold_upsample_conv_plain(x, K, bt, bc, A), nbytes(x, K, bt, bc) + nbytes(y),
              {"bf16": 2 * Tp * H * W * (kt * 4 * c) * (A * 4 * c)},
              ("cudnn", lambda: F.conv3d(xc, Ko, padding=(0, 1, 1))), "conv", path="720p")
        del x, K, y, xc, Ko


def window_rows(b: Bench):
    """K3 (3B) and K3q (7B) at WINDOW_SHAPES, Lt = 58, the plain and the
    shifted plan: the wrapper's whole call (the q/k preparation and the
    flash loop), then each kernel of this tree alone and the ablated flash
    loops on its prepared scratch. K3's library call: SDPA on already
    normalised and roped q/k with the text appended and the key mask; no
    torch call does K3q's int8 q/k attention."""
    here = b.libs["this"]
    entries = ("seedvr2_window_qk_prepare", "seedvr2_window_flash")
    for variant, thw, quant_qk, path in WINDOW_SHAPES:
        kid = "K3q" if quant_qk else "K3"
        if kid not in b.kernels:
            continue
        cfg = dit_3b() if variant == "3b" else dit_7b()
        H, D, Lt = cfg.heads, cfg.head_dim, 58
        for which, dp in zip(("plain", "shifted"), device_plans(build_attn_plans(cfg, thw, Lt), D, b.dev)):
            nW, S = dp.valid.shape
            vqkv, tqkv = b.randn(1, 3, H, nW, S, D), b.randn(1, 3, H, Lt, D)
            norms = 1 + b.randn(4, D, scale=0.1, dtype=torch.float32)
            wargs = (vqkv, tqkv, dp.vid_cos, dp.vid_sin, dp.txt_cos, dp.txt_sin, dp.valid, dp.rope_txt, norms, True,
                     cfg.norm_eps)
            prep = k3.qk_prepare(here, *wargs, quant_qk)
            keys = int(dp.valid.sum()) + nW * Lt  # every query row against the valid video and all text keys
            qk = 2 * H * (S + Lt) * keys * D
            tables = (dp.vid_cos, dp.vid_sin) + ((dp.txt_cos, dp.txt_sin) if dp.rope_txt else ())
            library = None
            if not quant_qk:
                q, k, v = (torch.cat([vqkv[0, i].permute(1, 0, 2, 3), tqkv[0, i][None].expand(nW, H, Lt, D)], dim=2)
                           for i in range(3))
                mask = torch.cat([dp.valid, torch.ones(nW, Lt, dtype=torch.bool, device=b.dev)], dim=1)[:, None, None]
                library = ("sdpa", lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            extra = {"this prep": lambda: k3.qk_prepare(here, *wargs, quant_qk),
                     "this flash": lambda: k3.window_flash(here, vqkv, tqkv, prep, quant_qk)}
            extra.update({f"{n} flash": (lambda L=L: k3.window_flash(L, vqkv, tqkv, prep, quant_qk))
                          for n, L in b.family("attn", entries).items() if n in b.ablation_of})
            b.row(f"{kid} {variant} {thw} {which} H{H} nW{nW} S{S} Lt{Lt}",
                  lambda: k3.fused_window_attention(*wargs, quant_qk=quant_qk),
                  lambda L: k3.window_flash(L, vqkv, tqkv, k3.qk_prepare(L, *wargs, quant_qk), quant_qk), entries,
                  k3.fused_window_attention_plain(*wargs, quant_qk=quant_qk),
                  lambda: k3.fused_window_attention_plain(*wargs, quant_qk=quant_qk),
                  nbytes(vqkv, tqkv, dp.valid, norms, *tables) + 2 * H * nW * (S + Lt) * D,  # + the bf16 outputs
                  {"int8": qk, "bf16": qk} if quant_qk else {"bf16": 2 * qk}, library, extra=extra, path=path)
            del vqkv, tqkv, prep, extra, library


def flash_rows(b: Bench):
    """K5 at the 7B unfused window attention's shapes (flash_shapes); the
    library call SDPA with the key mask."""
    for name, B, S, H, kv_valid in flash_shapes(b.dev):
        D = k5.HEAD_DIM
        q, k, v = (b.randn(B, S, H, D) for _ in range(3))
        o = torch.empty_like(q)

        def run(lib):
            cuda_lib.check(lib.seedvr2_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
                                                       None, o.data_ptr(), B, S, H, k5.padded_len(S) - S, 1.0 / D**0.5,
                                                       _stream()), "flash_attention")
            return o

        qt, kt, vt, mask = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_valid[:, None, None]
        qk = 2 * H * S * int(kv_valid.sum()) * D  # every query row against the valid keys of its batch row
        b.row(f"K5 {name} B{B} S{S} H{H}", lambda: k5.flash_attention(q, k, v, kv_valid), run,
              ("seedvr2_flash_attention",), k5.flash_attention_plain(q, k, v, kv_valid),
              lambda: k5.flash_attention_plain(q, k, v, kv_valid), nbytes(q, k, v, kv_valid, o), {"bf16": 2 * qk},
              ("sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)), "flash", path="720p")
        del q, k, v, o


def window_prepare_rows(b: Bench):
    """K11 at the 7B's plans (24 heads, 58 text tokens) against its plain
    version, the op chain it replaced on the unfused route; no library
    call. Bound by bytes: the qkv and text read once, the index, norms and
    tables, K5's three operands written once."""
    cfg = dit_7b()
    H, D, Lt = cfg.heads, cfg.head_dim, 58
    for thw, which, what, path in K11_SHAPES:
        dp = device_plans(build_attn_plans(cfg, thw, Lt), D, b.dev)[which]
        nW, mL = dp.valid.shape
        Lv = dp.inverse.numel()
        y, t = b.randn(1, Lv, 3, H, D), b.randn(1, Lt, 3, H, D)
        norms = 1 + b.randn(4, D, scale=0.1, dtype=torch.float32)
        args = (y, t, dp.index, dp.vid_cos, dp.vid_sin, dp.txt_cos, dp.txt_sin, dp.rope_txt, norms, True, cfg.norm_eps)
        out = torch.empty((3, nW, mL + Lt, H, D), dtype=torch.bfloat16, device=b.dev)
        tables = (dp.vid_cos, dp.vid_sin) + ((dp.txt_cos, dp.txt_sin) if dp.rope_txt else ())

        def run(lib):
            cuda_lib.check(lib.seedvr2_window_prepare(
                y.data_ptr(), t.data_ptr(), dp.index.data_ptr(), dp.vid_cos.data_ptr(), dp.vid_sin.data_ptr(),
                dp.txt_cos.data_ptr(), dp.txt_sin.data_ptr(), norms.data_ptr(), out.data_ptr(), 1, Lv, H, nW, mL, Lt,
                int(dp.rope_txt), 1, cfg.norm_eps, _stream()), "window_prepare")
            return out.unbind(0)

        b.row(f"K11 7b {what} {('plain', 'shifted')[which]} nW{nW} mL{mL} Lt{Lt} H{H}",
              lambda: k11.window_prepare(*args), run, ("seedvr2_window_prepare",), k11.window_prepare_plain(*args),
              lambda: k11.window_prepare_plain(*args), nbytes(y, t, dp.index, norms, *tables, out), {}, path=path)
        del y, t, args, out


def mid_attention_rows(b: Bench):
    """K10 at K10_SHAPES against its plain version (the per-frame fp32
    logits, softmax and bf16 copy); the library call SDPA on the same bf16
    q, k, v."""
    for frames, n, C, what, path in K10_SHAPES:
        q, k, v = (b.randn(frames, n, C) for _ in range(3))
        o = torch.empty_like(q)
        qh, kh, vh = (x[:, None] for x in (q, k, v))

        def run(lib):
            cuda_lib.check(lib.seedvr2_mid_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), frames, n,
                                                     C, 1.0 / C**0.5, _stream()), "mid_attention")
            return o

        b.row(f"K10 {what} F{frames} n{n} c{C}", lambda: k10.mid_attention(q, k, v), run, ("seedvr2_mid_attention",),
              k10.mid_attention_plain(q, k, v), lambda: k10.mid_attention_plain(q, k, v), nbytes(q, k, v, o),
              {"bf16": 4 * frames * n * n * C}, ("sdpa", lambda: F.scaled_dot_product_attention(qh, kh, vh)), path=path)
        del q, k, v, o, qh, kh, vh


def k7_rows(b: Bench):
    """K7 at the int8 DiT's linears (weights quantized from normal draws,
    bf16 inputs, the linear's bias where it has one): the 3B's and 7B's
    video (M 7200) and text (M 58) rows, the 3B qkv at the long clip's
    video rows (M 24,480) and the 7B at IMAGE_ROWS. The library call is
    cuBLAS's bf16 x @ w on the weight dequantized beforehand; the plain
    version is the whole chain (widen, product, scale, bias)."""
    rows = [(cfg.variant, M, shape) for cfg in (dit_3b(), dit_7b()) for M in (7200, 58)
            for shape in int8_linear_shapes(cfg)]
    rows.append(("3b", 24480, int8_linear_shapes(dit_3b())[0]))
    rows += [("7b", M, shape) for M in IMAGE_ROWS for shape in int8_linear_shapes(dit_7b())]
    entries = ("seedvr2_w8a16_linear", "seedvr2_w8a16_linear_splitk", "seedvr2_w8a16_splitk_splits")
    for variant, M, (name, K, N, has_bias) in rows:
        q = quant.quantize_linear(torch.randn(K, N, generator=b.g, device=b.dev) * K**-0.5)
        w_q, w_s, w_deq = q["w_q"].t().contiguous(), q["w_s"], quant.dequantize_weight(q)
        bias = b.randn(N) if has_bias else None
        x, y = b.randn(M, K), torch.empty((M, N), dtype=torch.bfloat16, device=b.dev)

        def run(lib):
            quant.launch(lib, x, w_q, w_s, bias, y)
            return y

        b.row(f"K7 {variant} {name} M{M} K{K} N{N}{' +bias' if has_bias else ''} ({quant.regime(M)})",
              lambda: quant.linear_apply(x, w_q, w_s, bias), run, entries, quant.linear_apply_plain(x, w_q, w_s, bias),
              lambda: quant.linear_apply_plain(x, w_q, w_s, bias),
              nbytes(x, w_q, w_s, y, *((bias,) if has_bias else ())), {"bf16": 2 * M * N * K},
              ("cublas", lambda: x @ w_deq), "K7", path="720p" if M in (7200, 58) else None, model=variant,
              mkn=(M, K, N))
        del q, w_q, w_s, w_deq, x, y


# kernel -> the rows that run it (K1 and K4 share theirs)
ROWS = {"K1": conv_rows, "K4": conv_rows, "K8": tables_rows, "K9": gn_apply_rows, "K2": fold_rows,
        "K3": window_rows, "K3q": window_rows, "K5": flash_rows, "K11": window_prepare_rows,
        "K10": mid_attention_rows, "K7": k7_rows}


def run(b: Bench) -> list:
    """The rows of the kernels ``b`` picks, in KERNELS' order (``b.rows``)."""
    for rows in dict.fromkeys(ROWS[k] for k in KERNELS if k in b.kernels):
        rows(b)
        torch.cuda.empty_cache()
    return b.rows


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--against", action="append", default=[], help="a csrc/ directory to build and time beside this tree")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--kernels", default=",".join(KERNELS), help=f"comma-separated subset of {','.join(KERNELS)}")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the conv kernels, K7, K3 / K3q's flash loop and K5 with one part taken out")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels: {sorted(set(kernels) - set(KERNELS))} not in {','.join(KERNELS)}")
    if not torch.cuda.is_available():
        raise SystemExit("conv_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions compute in true fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), torch.__version__, flush=True)
    libs = {"this": cuda_lib.library()}
    print("this tree:", ptxas_report(cuda_lib.build().log), flush=True)
    work = cuda_lib.BUILD_ROOT.parent / "conv_ab"
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
    run(Bench(libs, ablation_of, args.rounds, dev, kernels))


if __name__ == "__main__":
    main()
