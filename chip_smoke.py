#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises and the script exits non-zero without a result):
  1. card: name, power limit, versions;
  2. build: compile csrc/ with nvcc for sm_90a (build time, -Xptxas -v);
  3. kernels: K1, K2, K3 (3B), K3q and K5 (7B) against their plain PyTorch
     versions at the shapes of the 720p paths, bf16 inputs, bound
     ||k - p||_2 / ||p||_2 <= 1e-2 (the kernels round their outputs to bf16,
     ~4e-3); K3q must also reproduce its plain version's step away from
     unquantised attention (step share within 0.1 of 1, see compare());
     CUDA-event times of kernel, plain version and the nearest
     single PyTorch call (library_ms, a yardstick the port never calls);
     bound_ms from the shapes and the card's published peaks;
  4. reference: small 128-head-dim configs through phases.generate on the
     card (bf16, kernels) and on the CPU (fp32, plain versions), same
     weights and frames: the 3B-style one under "fused", the 7B-style one
     (window_pixel) under sageattn_2 (K3q) and flash_attn_2 (K5); mean
     |diff| <= 1e-2 and relative L2 <= 5e-2 (bf16 vs fp32 of the same
     pipeline measured 2.8e-3 and 1.6e-2 on CPU);
  5. main path: NaDiT-3B (32 layers, width 2560) and the VAE at full width
     with random weights drawn on the card, the bundled text embedding, a
     5-frame 640x360 clip upscaled to 1280x720 with the default pipeline
     settings through seedvr2_tpu_torch.pipeline.phases.generate;
  6. the 7B path: NaDiT-7B (36 layers, width 3072, 24 heads) and the VAE at
     full width, the same clip, once under sageattn_2 (K3q in every layer)
     and once under flash_attn_2 (K5 in every layer).
Every launch counter is set to 0 right before each driven run of phases 5
and 6 and read right after it; a kernel row's ``launches`` is the count of
the run that is its path (K1, K2, K3: phase 5; K3q, K5: their phase-6 run).
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


def compare(kid, name, source, replaces, kernel, plain, bytes_moved, ops, library=None, library_call=None, rival=None):
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
    }
    lib = "" if library is None else f"  library {row['library_ms']:.3f} ms"
    print(f"  {row['name']}: rel L2 {rel:.3e}  max|err| {err:.3e}{note}  kernel {row['ms']:.3f} ms"
          f"  plain {row['plain_ms']:.3f} ms  bound {bound_ms:.4f} ms ({bound_by}){lib}", flush=True)
    return row


def _window_attention_rows(dev, g, cfg, quant_qk):
    """K3 (3B) or K3q (7B) at the 720p geometry: patched latent (2, 45, 80),
    Lt = 58, the plain and the shifted plan."""
    import torch.nn.functional as F

    from seedvr2_tpu_torch.models.dit.nadit import build_attn_plans, device_plans
    from seedvr2_tpu_torch.ops import fused_window_attention as k3

    kid = "K3q" if quant_qk else "K3"
    H, D, Lt = cfg.heads, cfg.head_dim, 58
    rows = []
    for which, dp in zip(("plain", "shifted"), device_plans(build_attn_plans(cfg, (2, 45, 80), Lt), D, dev)):
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
            kid, f"{cfg.variant} {which} H{H} nW{nW} S{S} Lt{Lt}", "seedvr2_tpu_torch/csrc/window_attention.cuh",
            "seedvr2_tpu/ops/fused_window_attention.py:145" + (" (quant_qk=True, :100-117)" if quant_qk else ""),
            lambda: k3.fused_window_attention(*args, quant_qk=quant_qk),
            lambda: k3.fused_window_attention_plain(*args, quant_qk=quant_qk),
            moved, ops, library, call,
            rival=(lambda: k3.fused_window_attention_plain(*args, quant_qk=False)) if quant_qk else None,
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


def kernel_phase(dev):
    import torch.nn.functional as F

    from seedvr2_tpu_torch.config import dit_3b, dit_7b
    from seedvr2_tpu_torch.ops import conv3d_kernel as k1
    from seedvr2_tpu_torch.ops import fold_upsample_kernel as k2

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    # K1: the resnet convs of the 720p decode (latent 2x90x160 -> 5x720x1280)
    for c, T, H, W in ((512, 3, 180, 320), (256, 5, 360, 640), (128, 5, 720, 1280)):
        x = randn(1, T + 2, H, W, c)
        w = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5)
        b = torch.randn(c, generator=g, device=dev)
        w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
        xc = x.permute(0, 4, 1, 2, 3)
        rows.append(compare(
            "K1", f"conv3d_3x3x3 c{c} {T}x{H}x{W}", "seedvr2_tpu_torch/csrc/conv3d.cuh",
            "seedvr2_tpu/ops/conv3d_kernel.py:193",
            lambda: k1.conv3d_3x3x3(x, w, b), lambda: k1.conv3d_3x3x3_plain(x, w, b),
            nbytes(x, w, b) + T * H * W * c * 2, {"bf16": 2 * T * H * W * 27 * c * c},
            lambda: F.conv3d(xc, w_oidhw, b.bfloat16(), padding=(0, 1, 1)), "F.conv3d in bf16 (cuDNN), NCDHW view",
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


def reference_phase(dev, text, rope_type, mode):
    """The same small upscale on the card (bf16, kernels) and on the CPU
    (fp32, plain versions)."""
    from seedvr2_tpu_torch.models.dit.nadit import NaDiT
    from seedvr2_tpu_torch.models.params import init_random
    from seedvr2_tpu_torch.models.vae.model import VAE
    from seedvr2_tpu_torch.pipeline import phases
    from seedvr2_tpu_torch.pipeline.runner import Runner

    frames = np.random.RandomState(1).randint(0, 256, (5, 32, 48, 3)).astype(np.uint8)
    outs = []
    for device, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        cfg = small_config(rope_type).replace(compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
        dit = init_random(NaDiT(cfg.dit, device, dtype, mode), torch.Generator().manual_seed(11))
        vae = init_random(VAE(cfg.vae, device, dtype), torch.Generator().manual_seed(12))
        noise = torch.randn((2, 8, 12, 16), generator=torch.Generator().manual_seed(13))
        reset_counts()
        outs.append(phases.generate(Runner(cfg, dit, vae, text, device=device), frames, noise=noise))
        if device.type == "cuda":
            ran = read_counts()
    want = {"fused": "K3", "sageattn_2": "K3q", "flash_attn_2": "K5"}[mode]
    if ran[want] != cfg.dit.num_layers:
        raise RuntimeError(f"small {rope_type} {mode}: {want} ran {ran[want]} times, expected {cfg.dit.num_layers}")
    gpu, cpu = outs
    mean_err = float(np.abs(gpu - cpu).mean())
    rel = float(np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu - 0.5))
    print(f"  small {rope_type} {mode}: out {gpu.shape}, mean |gpu bf16 - cpu fp32| {mean_err:.3e}, rel L2 {rel:.3e}",
          flush=True)
    if not (gpu.shape == (5, 64, 96, 3) and np.isfinite(gpu).all() and mean_err <= 1e-2 and rel <= 5e-2):
        raise RuntimeError(f"small {rope_type} {mode}: card and CPU disagree (mean {mean_err:.3e}, rel {rel:.3e})")
    return {"rope_type": rope_type, "mode": mode, "mean_abs_diff": mean_err, "rel_l2": rel}


def drive(runner, frames, label):
    """One counted run (counters reset right before, read right after), then
    a second run for the steady wall time."""
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
    t0 = time.perf_counter()
    phases.generate(runner, frames)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    print(f"  {label}: out {out.shape} {out.dtype}, first run {wall:.3f} s, second run {wall2:.3f} s, "
          f"peak {peak:.2f} GiB, launches {launches}", flush=True)
    if out.shape != (5, 720, 1280, 3) or not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise RuntimeError(f"{label}: bad output {out.shape}")
    if float(out.std()) == 0.0:
        raise RuntimeError(f"{label}: constant output")
    if launches["K1"] == 0 or launches["K2"] == 0:
        raise RuntimeError(f"{label}: a VAE kernel never launched: {launches}")
    return launches, {"wall_s": wall, "second_run_wall_s": wall2, "peak_gib": peak}


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
    expect("3B fused", launches, {"K3": cfg.dit.num_layers, "K3q": 0, "K5": 0})
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
    return {"K3q": launches["K3q"], "K5": launches_f["K5"]}, out


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
    print(f"[2] build: {b.seconds:.1f} s -> {b.path}\n{b.log}", flush=True)

    print("[3] kernels vs plain versions", flush=True)
    rows = kernel_phase(dev)
    torch.cuda.empty_cache()

    text = load_text_embeddings()[0]  # pos [58, 5120]
    print("[4] small configs: card vs CPU", flush=True)
    small = [reference_phase(dev, text, rope, mode) for rope, mode in
             (("mmrope3d", "fused"), ("window_pixel", "sageattn_2"), ("window_pixel", "flash_attn_2"))]

    frames = np.random.RandomState(7).randint(0, 256, (5, 360, 640, 3)).astype(np.uint8)
    print("[5] main path: 3B + VAE, 5 x 640x360 -> 1280x720", flush=True)
    launches, e2e = main_path_phase(dev, text, frames)
    torch.cuda.empty_cache()  # the 3B runner is gone: room for the 7B weights

    print("[6] 7B + VAE, 5 x 640x360 -> 1280x720, sageattn_2 and flash_attn_2", flush=True)
    launches_7b, e2e_7b = path_7b_phase(dev, text, frames)
    launches.update(launches_7b)
    for row in rows:
        row["launches"] = launches[row["kernel"]]
    print(json.dumps({"kernels": rows, "e2e": {"3b_fused": e2e, **{f"7b_{k}": v for k, v in e2e_7b.items()}},
                      "small": small, "build_s": b.seconds}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
