#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises and the script exits non-zero without a result):
  1. card: name, power limit, versions;
  2. build: compile csrc/ with nvcc for sm_90a (build time, -Xptxas -v);
  3. kernels: K1, K2, K3 (3B), K3q and K5 (7B), K4 (K1 with the GroupNorm +
     SiLU prologue, tables from GroupNorm weights, at K1's shapes) and K6
     (the tap-folded conv) against their plain PyTorch
     versions at the shapes of the 720p paths, and K3 and K4 again at the
     long clip's shapes (phase 7's DiT latent 3 x 68 x 120; the c128 and
     c256 convs of one 608 x 1024 decode tile), bf16 inputs, bound
     ||k - p||_2 / ||p||_2 <= 1e-2 (the kernels round their outputs to bf16,
     ~4e-3); K3q must also reproduce its plain version's step away from
     unquantised attention (step share within 0.1 of 1, see compare());
     CUDA-event times of kernel, plain version and the nearest
     single PyTorch call (library_ms, a yardstick the port never calls);
     bound_ms from the shapes and the card's published peaks; K4 and K6
     rows also carry K1's time at the same shape (``k1_ms``), their rival,
     and K4 rows cuDNN's bf16 conv alone (``cudnn_conv_ms``); K6 runs at
     K1's three 720p decode shapes (c512 3x180x320, c256 5x360x640, c128
     5x720x1280), and its rows carry ptxas's register and spill lines and
     the runtime's registers, spill and dynamic shared memory for it;
  4. reference: small 128-head-dim configs through phases.generate on the
     card (bf16, kernels) and on the CPU (fp32, plain versions), same
     weights and frames: the 3B-style one under "fused", the 7B-style one
     (window_pixel) under sageattn_2 (K3q) and flash_attn_2 (K5), and the
     3B-style one through the 4-phase path (9 frames, overlap 2, tiled VAE,
     GroupNorm fusion: K4); mean |diff| <= 1e-2 and relative L2 <= 5e-2
     (bf16 vs fp32 of the same pipeline measured 2.8e-3 and 1.6e-2 on CPU);
  5. main path: NaDiT-3B (32 layers, width 2560) and the VAE at full width
     with random weights drawn on the card, the bundled text embedding, a
     5-frame 640x360 clip upscaled to 1280x720 with the default pipeline
     settings through seedvr2_tpu_torch.pipeline.phases.generate; then the
     same with the VAE's GroupNorm fusion on (K4 48 launches, K1 none);
  6. the 7B path: NaDiT-7B (36 layers, width 3072, 24 heads) and the VAE at
     full width, the same clip, once under sageattn_2 (K3q in every layer)
     and once under flash_attn_2 (K5 in every layer);
  7. the long-clip path: NaDiT-3B and the VAE at full width, a 15-frame
     960x540 clip upscaled to 1920x1080 through the 4-phase pipeline:
     batch_size 9 with temporal_overlap 3 (two batches, Hann blend), the
     tiled VAE at its default tiles (2x2 in encode and decode), GroupNorm
     fusion on (K4 in every resnet conv), wavelet colour.
Every launch counter is set to 0 right before each driven run of phases 5,
6 and 7 and read right after it; a kernel row's ``launches`` is the count
of the run that is its path at the row's shapes (K1, K2, K3: phase 5; K4:
phase 5 with GroupNorm fusion; K3q, K5: their phase-6 run; the 1080p K3
rows and the long-clip K4 rows: phase 7); phase 7's counts also stand under
``e2e.long_clip.launches``. K6 is on no path (the JAX package reaches it
only from its benchmark scripts): its row's count is its sum over every
driven run, which must be 0.
Then: the kernels JSON line, the card line, and the final JSON line.
"""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REL_BOUND = 1e-2
# NVIDIA H100 SXM published peaks (dense, at the 700 W limit)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: dict):
    """Least time on the card: the larger of the bytes over the memory rate
    and the operations over the peak rate of their type (ms, and which)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items()) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_counters():
    from seedvr2_tpu_torch.ops import conv3d_kernel as k1
    from seedvr2_tpu_torch.ops import flash_attention as k5
    from seedvr2_tpu_torch.ops import fold_upsample_kernel as k2
    from seedvr2_tpu_torch.ops import fused_window_attention as k3

    return {
        "K1": (k1.conv3d_3x3x3, "launches"),
        "K2": (k2.fold_upsample_conv, "launches"),
        "K3": (k3.fused_window_attention, "launches"),
        "K3q": (k3.fused_window_attention, "launches_int8"),
        "K5": (k5.flash_attention, "launches"),
        "K4": (k1.conv3d_3x3x3, "launches_gn"),
        "K6": (k1.conv3d_3x3x3_im2col, "launches"),
    }


def reset_counts():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {kid: getattr(fn, attr) for kid, (fn, attr) in kernel_counters().items()}


def _tuple(x):
    return tuple(t.float() for t in (x if isinstance(x, tuple) else (x,)))


def _rel(got_t, ref_t):
    return max(float((g - r).norm() / r.norm()) for g, r in zip(got_t, ref_t))


def compare(kid, name, source, replaces, kernel, plain, bytes_moved, ops, library=None, library_call=None, rival=None,
            extra_row=None):
    """Run kernel and plain version on the same inputs, check, time both,
    and the library call where one exists. ``rival`` is a plain version of
    a nearby function that the kernel must not be mistaken for (K3q: the
    same attention without int8 q/k). The bf16 output rounding (~3e-3) and
    the int8 step (~1e-2 relative at these inputs) are of one size, so a
    rel L2 bound alone cannot tell them apart; the share of the step that
    the kernel reproduces can: <k - r, p - r> / <p - r, p - r> is ~0.95
    for a kernel that quantises q and k, ~0.5 for one that quantises only
    one of them and ~0.05 for one that does not. The kernel's own output
    rounding is uncorrelated with the step and averages out over ~1e7
    elements; the plain versions' bf16 output rounding (~2e-3 of a ~1e-2
    step) stays in the denominator and moves the ends 0.05 inwards."""
    got_t, ref_t = _tuple(kernel()), _tuple(plain())
    torch.cuda.synchronize()
    rel = _rel(got_t, ref_t)
    err = max(float((g - r).abs().max()) for g, r in zip(got_t, ref_t))
    if not (rel <= REL_BOUND and all(bool(torch.isfinite(g).all()) for g in got_t)):
        raise RuntimeError(f"{kid} {name}: kernel disagrees with its plain version (rel L2 {rel:.3e} > {REL_BOUND})")
    extra, note = {}, ""
    if rival is not None:
        riv_t = _tuple(rival())
        step = sum(float(((r - v) * (r - v)).sum()) for r, v in zip(ref_t, riv_t))
        share = sum(float(((g - v) * (r - v)).sum()) for g, r, v in zip(got_t, ref_t, riv_t)) / step
        extra = {"rel_l2_rival": _rel(got_t, riv_t), "rival_gap_rel_l2": _rel(ref_t, riv_t), "step_share": share}
        note = (f"  rel L2 to the rival {extra['rel_l2_rival']:.3e} (rival vs plain {extra['rival_gap_rel_l2']:.3e})"
                f"  step share {share:.4f}")
        if not (abs(share - 1.0) <= 0.1 and rel < extra["rel_l2_rival"]):
            raise RuntimeError(f"{kid} {name}: the kernel does not reproduce its plain version's step away from the "
                               f"rival (share {share:.4f}, rel {rel:.3e} vs rival {extra['rel_l2_rival']:.3e})")
        del riv_t
    del got_t, ref_t
    bound_ms, bound_by = bound(bytes_moved, ops)
    row = {
        "name": f"{kid} {name}", "kernel": kid, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "rel_l2": rel, **extra, "ms": cuda_ms(kernel, 20),
        "plain_ms": cuda_ms(plain, 3), "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None if library is None else cuda_ms(library, 20), "library_call": library_call,
        **(extra_row or {}),
    }
    lib = "" if library is None else f"  library {row['library_ms']:.3f} ms"
    print(f"  {row['name']}: rel L2 {rel:.3e}  max|err| {err:.3e}{note}  kernel {row['ms']:.3f} ms"
          f"  plain {row['plain_ms']:.3f} ms  bound {bound_ms:.4f} ms ({bound_by}){lib}", flush=True)
    return row


def _window_attention_rows(dev, g, cfg, quant_qk, thw=(2, 45, 80), res="", path="main"):
    """K3 (3B) or K3q (7B) at a patched latent geometry, Lt = 58, the plain
    and the shifted plan: the 720p paths' (2, 45, 80) by default; the long
    clip's 1080p batch of 9 frames is (3, 68, 120) (1080x1920 padded to
    1088x1920, /8 by the VAE, /2 by the patch; 9 frames -> 3 latents).
    ``path`` names the run whose count the row carries."""
    import torch.nn.functional as F

    from seedvr2_tpu_torch.models.dit.nadit import build_attn_plans, device_plans
    from seedvr2_tpu_torch.ops import fused_window_attention as k3

    kid = "K3q" if quant_qk else "K3"
    H, D, Lt = cfg.heads, cfg.head_dim, 58
    rows = []
    for which, dp in zip(("plain", "shifted"), device_plans(build_attn_plans(cfg, thw, Lt), D, dev)):
        nW, S = dp.valid.shape
        vqkv = torch.randn((1, 3, H, nW, S, D), generator=g, device=dev).bfloat16()
        tqkv = torch.randn((1, 3, H, Lt, D), generator=g, device=dev).bfloat16()
        norms = 1 + 0.1 * torch.randn(4, D, generator=g, device=dev)
        args = (vqkv, tqkv, dp.vid_cos, dp.vid_sin, dp.txt_cos, dp.txt_sin, dp.valid, dp.rope_txt, norms, True, cfg.norm_eps)
        # work this data needs: every query row, the valid video keys and all text keys of its window
        keys = int(dp.valid.sum()) + nW * Lt
        qk = 2 * H * (S + Lt) * keys * D
        ops = {"int8": qk, "bf16": qk} if quant_qk else {"bf16": 2 * qk}
        tables = (dp.vid_cos, dp.vid_sin) + ((dp.txt_cos, dp.txt_sin) if dp.rope_txt else ())
        moved = nbytes(vqkv, tqkv, dp.valid, norms, *tables) + 2 * H * nW * (S + Lt) * D  # + bf16 outputs
        library = call = None
        if not quant_qk:
            # nearest single call: SDPA on already normalised and roped q/k with the text appended, key mask
            q, k, v = (torch.cat([vqkv[0, i].permute(1, 0, 2, 3), tqkv[0, i][None].expand(nW, H, Lt, D)], dim=2)
                       for i in range(3))
            mask = torch.cat([dp.valid, torch.ones(nW, Lt, dtype=torch.bool, device=dev)], dim=1)[:, None, None]

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

            call = "F.scaled_dot_product_attention on pre-normed, pre-roped q/k/v [nW, H, S+Lt, D] with the key mask"
        rows.append(compare(
            kid, f"{cfg.variant} {res}{which} H{H} nW{nW} S{S} Lt{Lt}", "seedvr2_tpu_torch/csrc/window_attention.cuh",
            "seedvr2_tpu/ops/fused_window_attention.py:145" + (" (quant_qk=True, :100-117)" if quant_qk else ""),
            lambda: k3.fused_window_attention(*args, quant_qk=quant_qk),
            lambda: k3.fused_window_attention_plain(*args, quant_qk=quant_qk),
            moved, ops, library, call,
            rival=(lambda: k3.fused_window_attention_plain(*args, quant_qk=False)) if quant_qk else None,
            extra_row={"path": path},
        ))
    return rows


def _flash_attention_rows(dev, g, cfg):
    """K5 at the 7B unfused window attention's shapes: B*nW windows of
    S = mL + Lt rows, keys valid = [window validity | all text]."""
    import torch.nn.functional as F

    from seedvr2_tpu_torch.models.dit.nadit import build_attn_plans, device_plans
    from seedvr2_tpu_torch.ops import flash_attention as k5

    H, D, Lt = cfg.heads, cfg.head_dim, 58
    rows = []
    for which, dp in zip(("plain", "shifted"), device_plans(build_attn_plans(cfg, (2, 45, 80), Lt), D, dev)):
        nW, mL = dp.valid.shape
        S = mL + Lt
        q, k, v = (torch.randn((nW, S, H, D), generator=g, device=dev).bfloat16() for _ in range(3))
        kv_valid = torch.cat([dp.valid, torch.ones(nW, Lt, dtype=torch.bool, device=dev)], dim=1).contiguous()
        qk = 2 * H * S * int(kv_valid.sum()) * D
        moved = nbytes(q, k, v, kv_valid) + nbytes(q)  # + the bf16 output
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = kv_valid[:, None, None]
        rows.append(compare(
            "K5", f"{cfg.variant} {which} B{nW} S{S} H{H}", "seedvr2_tpu_torch/csrc/flash_attention.cuh",
            "seedvr2_tpu/ops/flash_attention.py:96",
            lambda: k5.flash_attention(q, k, v, kv_valid), lambda: k5.flash_attention_plain(q, k, v, kv_valid),
            moved, {"bf16": 2 * qk},
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            "F.scaled_dot_product_attention on the [B, H, S, D] views with the key mask",
        ))
    return rows


def long_clip_conv_shapes():
    """(C, T, H, W) of the c128 and c256 resnet convs of one tile of phase 7's
    tiled decode: the 1080p frame padded to a multiple of 16 (1088 x 1920) is
    a 136 x 240 latent, which the decode's grid (1024 px tiles, 128 px
    overlap) cuts into 76 x 128 latent tiles, i.e. 608 x 1024 px (c128) and
    304 x 512 (c256); the first temporal slice of a 9-frame batch decodes 2
    latent frames into 5."""
    from seedvr2_tpu_torch.config import PipelineConfig
    from seedvr2_tpu_torch.models.vae import tiling
    from seedvr2_tpu_torch.profile_batch import long_clip_config, long_clip_frames

    cfg = long_clip_config(PipelineConfig())
    sf = cfg.vae.spatial_downsample_factor
    fh, fw = long_clip_frames().shape[1:3]
    lat = [-(-n // 16) * 16 // sf for n in (cfg.resolution, cfg.resolution * fw // fh)]
    tile = []
    for n, size, ov in zip(lat, cfg.decode_tile_size, cfg.decode_tile_overlap):
        ltmax = size // sf
        lo = max(0, min(tiling.effective_pixel_overlap(ov, n, ltmax, sf) // sf, ltmax - 1))
        tile.append(tiling._axis_grid(n, ltmax, lo)[0])
    return [(128, 5, tile[0] * sf, tile[1] * sf), (256, 5, tile[0] * sf // 2, tile[1] * sf // 2)]


def _conv_rows(dev, g, c, T, H, W, k1_ms, path="main"):
    """K1 (on the main path only) and K4 rows at one resnet conv shape. K4's
    library call is the three-call chain it fuses; ``cudnn_conv_ms`` is
    cuDNN's bf16 F.conv3d at the same shape, its rival for the conv alone."""
    import torch.nn.functional as F

    from seedvr2_tpu_torch.ops import conv3d_kernel as k1

    x = (torch.randn((1, T + 2, H, W, c), generator=g, device=dev)).bfloat16()
    w = (torch.randn((3, 3, 3, c, c), generator=g, device=dev) * (27 * c) ** -0.5).bfloat16()
    b = torch.randn(c, generator=g, device=dev)
    w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
    xc = x.permute(0, 4, 1, 2, 3)
    ops = {"bf16": 2 * T * H * W * 27 * c * c}
    shape = f"c{c} {T}x{H}x{W}"
    rows = []

    def cudnn():
        return F.conv3d(xc, w_oidhw, b.bfloat16(), padding=(0, 1, 1))

    if path == "main":
        rows.append(compare(
            "K1", f"conv3d_3x3x3 {shape}", "seedvr2_tpu_torch/csrc/conv3d.cuh",
            "seedvr2_tpu/ops/conv3d_kernel.py:193",
            lambda: k1.conv3d_3x3x3(x, w, b), lambda: k1.conv3d_3x3x3_plain(x, w, b),
            nbytes(x, w, b) + T * H * W * c * 2, ops, cudnn, "F.conv3d in bf16 (cuDNN), NCDHW view",
        ))
        k1_ms[shape] = (rows[-1]["ms"], rows[-1]["library_ms"])
    gw = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    gb = 0.3 * torch.randn(c, generator=g, device=dev)
    scale, shift = k1.gn_silu_tables(x, gw, gb, 32)

    def chain():
        h = x.permute(0, 1, 4, 2, 3).reshape(T + 2, c, H, W)  # per-frame GroupNorm on NCHW frames
        h = F.silu(F.group_norm(h, 32, gw.bfloat16(), gb.bfloat16(), eps=1e-6))
        return F.conv3d(h.reshape(1, T + 2, c, H, W).transpose(1, 2), w_oidhw, b.bfloat16(), padding=(0, 1, 1))

    extra = {"path": path}
    if shape in k1_ms:
        extra.update(k1_ms=k1_ms[shape][0], cudnn_conv_ms=k1_ms[shape][1])
    else:
        extra["cudnn_conv_ms"] = cuda_ms(cudnn, 20)
    rows.append(compare(
        "K4", f"conv3d_3x3x3 + GroupNorm/SiLU prologue {shape}" + (" (long clip)" if path == "long_clip" else ""),
        "seedvr2_tpu_torch/csrc/conv3d.cuh", "seedvr2_tpu/ops/conv3d_kernel.py:193 (scale=, shift=: _kernel_gn :100)",
        lambda: k1.conv3d_3x3x3(x, w, b, scale, shift), lambda: k1.conv3d_3x3x3_plain(x, w, b, scale, shift),
        nbytes(x, w, b, scale, shift) + T * H * W * c * 2, ops, chain,
        "chain: per-frame F.group_norm + F.silu + cuDNN bf16 F.conv3d (channels-first copies of x included)",
        extra_row=extra,
    ))
    return rows


def kernel_phase(dev):
    import torch.nn.functional as F

    from seedvr2_tpu_torch.config import dit_3b, dit_7b
    from seedvr2_tpu_torch.ops import conv3d_kernel as k1
    from seedvr2_tpu_torch.ops import cuda_lib
    from seedvr2_tpu_torch.ops import fold_upsample_kernel as k2

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    # K1: the resnet convs of the 720p decode (latent 2x90x160 -> 5x720x1280);
    # K4: the same convs with the resnet's GroupNorm + SiLU folded into the
    # load (tables from GroupNorm weights of the input), and again at the long
    # clip's decode-tile shapes (phase 7's path, no K1 there); K6: the folded
    # product at K1's shapes
    k1_ms = {}
    for c, T, H, W in ((512, 3, 180, 320), (256, 5, 360, 640), (128, 5, 720, 1280)):
        rows += _conv_rows(dev, g, c, T, H, W, k1_ms)
    for c, T, H, W in long_clip_conv_shapes():
        rows += _conv_rows(dev, g, c, T, H, W, k1_ms, path="long_clip")
    k6_build = {**k1.im2col_kernel_attributes(),
                "ptxas": [line for _, line in cuda_lib.ptxas_lines(cuda_lib.build().log, "im2col")]}
    print(f"  K6 kernel: {k6_build}", flush=True)
    for c, T, H, W in ((512, 3, 180, 320), (256, 5, 360, 640), (128, 5, 720, 1280)):
        x = randn(1, T + 2, H, W, c)
        w = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5)
        b = torch.randn(c, generator=g, device=dev)
        w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
        xc = x.permute(0, 4, 1, 2, 3)
        shape = f"c{c} {T}x{H}x{W}"
        rows.append(compare(
            "K6", f"conv3d_3x3x3_im2col {shape}", "seedvr2_tpu_torch/csrc/conv3d_im2col.cuh",
            "seedvr2_tpu/ops/conv3d_kernel.py:323",
            lambda: k1.conv3d_3x3x3_im2col(x, w, b), lambda: k1.conv3d_3x3x3_im2col_plain(x, w, b),
            nbytes(x, w, b) + T * H * W * c * 2, {"bf16": 2 * T * H * W * 27 * c * c},
            lambda: F.conv3d(xc, w_oidhw, b.bfloat16(), padding=(0, 1, 1)), "F.conv3d in bf16 (cuDNN), NCDHW view",
            extra_row={"k1_ms": k1_ms[shape][0], **k6_build},
        ))
        del x, xc
    # K2: the decoder's three upsamples at 720p (the phase-pure call of each)
    for c, kt, A, Tin, H, W in ((512, 2, 2, 2, 90, 160), (512, 2, 2, 3, 180, 320), (256, 3, 1, 7, 360, 640)):
        x = randn(1, Tin, H, W, c)
        K = randn(kt, 2, 2, c, A * 4 * c, scale=(kt * 4 * c) ** -0.5)
        btab = torch.randn(2, 2, A * 4 * c, generator=g, device=dev)
        bc = torch.randn(c, generator=g, device=dev)
        Tp = Tin - kt + 1
        xc = x.permute(0, 4, 1, 2, 3)
        K_oidhw = K.permute(4, 3, 0, 1, 2).contiguous()
        rows.append(compare(
            "K2", f"fold_upsample_conv c{c} kt{kt} A{A} {Tin}x{H}x{W}", "seedvr2_tpu_torch/csrc/fold_upsample.cuh",
            "seedvr2_tpu/ops/fold_upsample_kernel.py:116",
            lambda: k2.fold_upsample_conv(x, K, btab, bc, A), lambda: k2.fold_upsample_conv_plain(x, K, btab, bc, A),
            nbytes(x, K, btab, bc) + Tp * A * 4 * H * W * c * 2, {"bf16": 2 * Tp * H * W * (kt * 4 * c) * (A * 4 * c)},
            lambda: F.conv3d(xc, K_oidhw, padding=(0, 1, 1)),
            "F.conv3d in bf16 (cuDNN) of the folded kt x 2 x 2 weight, no bias table, no depth-to-space",
        ))
        del x, xc
    rows += _window_attention_rows(dev, g, dit_3b(), quant_qk=False)
    rows += _window_attention_rows(dev, g, dit_3b(), quant_qk=False, thw=(3, 68, 120), res="1080p ", path="long_clip")
    rows += _window_attention_rows(dev, g, dit_7b(), quant_qk=True)
    rows += _flash_attention_rows(dev, g, dit_7b())
    return rows


def small_config(rope_type="mmrope3d"):
    from seedvr2_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig

    vae = VAEConfig(block_out_channels=(128, 128, 256, 256), layers_per_block=1)
    dit = DiTConfig(variant="small", vid_dim=256, txt_dim=256, emb_dim=6 * 256, heads=2, num_layers=2, mm_layers=1,
                    swiglu_multiple_of=64, sinusoidal_dim=64)
    if rope_type == "window_pixel":  # the 7B structure at a small width
        dit = DiTConfig(variant="small", vid_dim=256, txt_dim=256, emb_dim=6 * 256, heads=2, num_layers=2, mm_layers=2,
                        mlp_type="normal", rope_type="window_pixel", rope_dim=64, vid_out_norm=False,
                        last_layer_vid_only=False, sinusoidal_dim=64)
    return PipelineConfig(dit=dit, vae=vae, resolution=64)


# the 4-phase long-clip settings at the small size: 9 frames in 5-frame
# batches overlapping by 2, the tiled VAE (a 2x3 grid of 40x48 px tiles in
# encode and decode), GroupNorm fusion
SMALL_LONG_CLIP = dict(temporal_overlap=2, encode_tiled=True, decode_tiled=True, encode_tile_size=(48, 48),
                       encode_tile_overlap=(16, 16), decode_tile_size=(48, 48), decode_tile_overlap=(16, 16))


def reference_phase(dev, text, rope_type, mode, long_clip=False):
    """The same small upscale on the card (bf16, kernels) and on the CPU
    (fp32, plain versions); ``long_clip``: through the 4-phase path with
    the tiled VAE and GroupNorm fusion (SMALL_LONG_CLIP)."""
    from seedvr2_tpu_torch.models.dit.nadit import NaDiT
    from seedvr2_tpu_torch.models.params import init_random
    from seedvr2_tpu_torch.models.vae.model import VAE
    from seedvr2_tpu_torch.pipeline import phases
    from seedvr2_tpu_torch.pipeline.runner import Runner

    n = 9 if long_clip else 5
    frames = np.random.RandomState(1).randint(0, 256, (n, 32, 48, 3)).astype(np.uint8)
    outs = []
    for device, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        cfg = small_config(rope_type).replace(compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
                                              **(SMALL_LONG_CLIP if long_clip else {}))
        dit = init_random(NaDiT(cfg.dit, device, dtype, mode), torch.Generator().manual_seed(11))
        vae = init_random(VAE(cfg.vae, device, dtype, gn_fusion=long_clip), torch.Generator().manual_seed(12))
        noise = torch.randn((2, 8, 12, 16), generator=torch.Generator().manual_seed(13))
        reset_counts()
        outs.append(phases.generate(Runner(cfg, dit, vae, text, device=device), frames, noise=noise))
        if device.type == "cuda":
            ran = read_counts()
    want = {"fused": "K3", "sageattn_2": "K3q", "flash_attn_2": "K5"}[mode]
    n_batches = 3 if long_clip else 1
    label = f"small {rope_type} {mode}" + (" 4-phase tiled gn_fusion" if long_clip else "")
    if ran[want] != cfg.dit.num_layers * n_batches:
        raise RuntimeError(f"{label}: {want} ran {ran[want]} times, expected {cfg.dit.num_layers * n_batches}")
    if long_clip and not (ran["K4"] > 0 and ran["K1"] == 0):
        raise RuntimeError(f"{label}: expected K4 and no K1 launches, got {ran}")
    gpu, cpu = outs
    mean_err = float(np.abs(gpu - cpu).mean())
    rel = float(np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu - 0.5))
    print(f"  {label}: out {gpu.shape}, mean |gpu bf16 - cpu fp32| {mean_err:.3e}, rel L2 {rel:.3e}, "
          f"launches {ran}", flush=True)
    if not (gpu.shape == (n, 64, 96, 3) and np.isfinite(gpu).all() and mean_err <= 1e-2 and rel <= 5e-2):
        raise RuntimeError(f"{label}: card and CPU disagree (mean {mean_err:.3e}, rel {rel:.3e})")
    return {"rope_type": rope_type, "mode": mode, "long_clip": long_clip, "mean_abs_diff": mean_err, "rel_l2": rel}


def drive(runner, frames, label, out_shape=(5, 720, 1280, 3), runs=2):
    """One counted run (counters reset right before, read right after), then
    with ``runs=2`` a second run for the steady wall time."""
    from seedvr2_tpu_torch.pipeline import phases

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = phases.generate(runner, frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    e2e = {"wall_s": wall, "peak_gib": peak}
    note = ""
    if runs == 2:
        t0 = time.perf_counter()
        phases.generate(runner, frames)
        torch.cuda.synchronize()
        e2e["second_run_wall_s"] = time.perf_counter() - t0
        note = f", second run {e2e['second_run_wall_s']:.3f} s"
    print(f"  {label}: out {out.shape} {out.dtype}, first run {wall:.3f} s{note}, "
          f"peak {peak:.2f} GiB, launches {launches}", flush=True)
    if out.shape != out_shape or not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise RuntimeError(f"{label}: bad output {out.shape}")
    if float(out.std()) == 0.0:
        raise RuntimeError(f"{label}: constant output")
    if launches["K1"] + launches["K4"] == 0 or launches["K2"] == 0:
        raise RuntimeError(f"{label}: a VAE kernel never launched: {launches}")
    return launches, e2e


def expect(label, launches, want):
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if bad:
        raise RuntimeError(f"{label}: launches (got, expected) {bad}")


def main_path_phase(dev, text, frames):
    from seedvr2_tpu_torch.config import PipelineConfig
    from seedvr2_tpu_torch.io.weights import random_dit, random_vae
    from seedvr2_tpu_torch.pipeline.runner import Runner

    cfg = PipelineConfig(resolution=720)  # 3B, bf16, wavelet, batch 5, untiled VAE, 16-bit out
    g = torch.Generator(device=dev).manual_seed(42)
    t0 = time.perf_counter()
    runner = Runner(cfg, random_dit(cfg.dit, g), random_vae(cfg.vae, g), text, device=dev)
    torch.cuda.synchronize()
    print(f"  3B weights on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    launches, e2e = drive(runner, frames, "3B fused")
    # 48 resnet convs (20 in the encoder, 28 in the decoder); K2 per decoder upsample and latent slice
    expect("3B fused", launches, {"K1": 48, "K2": 6, "K3": cfg.dit.num_layers, "K3q": 0, "K5": 0, "K4": 0})
    # the same path with the resnets' GroupNorm + SiLU folded into their convs
    runner.vae.set_gn_fusion(True)
    launches_gn, e2e_gn = drive(runner, frames, "3B fused gn_fusion")
    expect("3B fused gn_fusion", launches_gn, {"K4": 48, "K1": 0, "K2": 6, "K3": cfg.dit.num_layers})
    return launches, launches_gn, {"3b_fused": e2e, "3b_fused_gn_fusion": e2e_gn}


def long_clip_phase(dev, text):
    """Phase 7: 3B + VAE at full width, 15 x 960x540 -> 1920x1080 through the
    4-phase pipeline (batch 9, overlap 3, tiled VAE, GroupNorm fusion)."""
    from seedvr2_tpu_torch.config import PipelineConfig
    from seedvr2_tpu_torch.io.weights import random_dit, random_vae
    from seedvr2_tpu_torch.pipeline.runner import Runner
    from seedvr2_tpu_torch.profile_batch import long_clip_config, long_clip_frames

    cfg = long_clip_config(PipelineConfig())
    g = torch.Generator(device=dev).manual_seed(44)
    runner = Runner(cfg, random_dit(cfg.dit, g), random_vae(cfg.vae, g).set_gn_fusion(True), text, device=dev)
    launches, e2e = drive(runner, long_clip_frames(), "3B long clip", out_shape=(15, 1080, 1920, 3), runs=1)
    # 2 batches x (20 resnet convs x 2 encode slices + 28 x 2 decode slices) x 4 tiles; 32 layers x 2 batches
    expect("3B long clip", launches, {"K4": 768, "K1": 0, "K2": 72, "K3": 64, "K3q": 0, "K5": 0})
    return launches, e2e


def path_7b_phase(dev, text, frames):
    from seedvr2_tpu_torch.config import pipeline_7b
    from seedvr2_tpu_torch.io.weights import random_dit, random_vae
    from seedvr2_tpu_torch.pipeline.runner import Runner

    cfg = pipeline_7b(resolution=720)
    g = torch.Generator(device=dev).manual_seed(43)
    t0 = time.perf_counter()
    dit = random_dit(cfg.dit, g).set_attention_mode("sageattn_2")
    runner = Runner(cfg, dit, random_vae(cfg.vae, g), text, device=dev)
    torch.cuda.synchronize()
    print(f"  7B weights on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    n = cfg.dit.num_layers
    out = {}
    launches, out["sageattn_2"] = drive(runner, frames, "7B sageattn_2")
    expect("7B sageattn_2", launches, {"K3q": n, "K3": 0, "K5": 0})
    runner.dit.set_attention_mode("flash_attn_2")
    launches_f, out["flash_attn_2"] = drive(runner, frames, "7B flash_attn_2")
    expect("7B flash_attn_2", launches_f, {"K5": n, "K3": 0, "K3q": 0})
    return launches, launches_f, out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain references compute in true fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {name} | {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from seedvr2_tpu_torch.io.weights import load_text_embeddings
    from seedvr2_tpu_torch.ops import cuda_lib

    shutil.rmtree(cuda_lib.BUILD_ROOT / cuda_lib.source_hash(), ignore_errors=True)  # build from these sources now
    b = cuda_lib.build()
    cuda_lib.library()
    print(f"[2] build: {b.seconds:.1f} s -> {b.path} (nvcc per source {[round(t, 1) for t in b.compile_seconds]} s, "
          f"sum {sum(b.compile_seconds):.1f} s)\n{b.log}", flush=True)

    print("[3] kernels vs plain versions", flush=True)
    rows = kernel_phase(dev)
    torch.cuda.empty_cache()

    text = load_text_embeddings()[0]  # pos [58, 5120]
    print("[4] small configs: card vs CPU", flush=True)
    small = [reference_phase(dev, text, rope, mode) for rope, mode in
             (("mmrope3d", "fused"), ("window_pixel", "sageattn_2"), ("window_pixel", "flash_attn_2"))]
    small.append(reference_phase(dev, text, "mmrope3d", "fused", long_clip=True))

    frames = np.random.RandomState(7).randint(0, 256, (5, 360, 640, 3)).astype(np.uint8)
    print("[5] main path: 3B + VAE, 5 x 640x360 -> 1280x720", flush=True)
    launches, launches_gn, e2e = main_path_phase(dev, text, frames)
    torch.cuda.empty_cache()  # the 3B runner is gone: room for the 7B weights

    print("[6] 7B + VAE, 5 x 640x360 -> 1280x720, sageattn_2 and flash_attn_2", flush=True)
    launches_q, launches_f, e2e_7b = path_7b_phase(dev, text, frames)
    torch.cuda.empty_cache()

    print("[7] long clip: 3B + VAE, 15 x 960x540 -> 1920x1080, 4 phases, overlap 3, tiled VAE, gn_fusion",
          flush=True)
    launches_long, e2e_long = long_clip_phase(dev, text)
    print(f"  K2 launches in the long clip: {launches_long['K2']}", flush=True)
    k6 = sum(n["K6"] for n in (launches, launches_gn, launches_q, launches_f, launches_long))
    if k6 != 0:
        raise RuntimeError(f"K6 is on no path but launched {k6} times")
    launches.update(K4=launches_gn["K4"], K3q=launches_q["K3q"], K5=launches_f["K5"], K6=k6)
    for row in rows:
        row["launches"] = (launches_long if row.get("path") == "long_clip" else launches)[row["kernel"]]
    e2e.update({f"7b_{k}": v for k, v in e2e_7b.items()}, long_clip=dict(e2e_long, launches=launches_long))
    print(json.dumps({"kernels": rows, "e2e": e2e, "small": small, "build_s": b.seconds,
                      "build_nvcc_s": b.compile_seconds}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
