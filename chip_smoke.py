#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises and the script exits non-zero without a result):
  1. card: name, power limit, versions;
  2. build: compile csrc/ with nvcc for sm_90a (build time, -Xptxas -v);
  3. kernels: K1, K2, K3 against their plain PyTorch versions at the shapes
     of the 720p main path, bf16 inputs, bound ||k - p||_2 / ||p||_2 <= 1e-2
     (the kernels round their outputs to bf16, ~4e-3); CUDA-event times of
     kernel, plain version and, for the convs, cuDNN in bf16;
  4. reference: a small 128-channel config through phases.generate on the
     card (bf16, kernels) and on the CPU (fp32, plain versions), same
     weights and frames: mean |diff| <= 1e-2 and relative L2 <= 5e-2
     (bf16 vs fp32 of the same pipeline measured 2.8e-3 and 1.6e-2 on CPU);
  5. main path: NaDiT-3B (32 layers, width 2560) and the VAE at full width
     with random weights drawn on the card, the bundled text embedding, a
     5-frame 640x360 clip upscaled to 1280x720 with the default pipeline
     settings through seedvr2_tpu_torch.pipeline.phases.generate; launch
     counters reset right before and read right after that one run.
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


def compare(name, route, source, replaces, kernel, plain, library=None):
    """Run kernel and plain version on the same inputs, check, time both."""
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    ref_t = ref if isinstance(ref, tuple) else (ref,)
    rel = max(float((g.float() - r.float()).norm() / r.float().norm()) for g, r in zip(got_t, ref_t))
    err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got_t, ref_t))
    if not (rel <= REL_BOUND and all(bool(torch.isfinite(g).all()) for g in got_t)):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version (rel L2 {rel:.3e} > {REL_BOUND})")
    row = {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "max_abs_err": err, "rel_l2": rel, "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 3),
    }
    if library is not None:
        row["cudnn_bf16_ms"] = cuda_ms(library, 20)
    print(f"  {name}: rel L2 {rel:.3e}  max|err| {err:.3e}  kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms"
          + (f"  cuDNN bf16 {row['cudnn_bf16_ms']:.3f} ms" if library is not None else ""), flush=True)
    return row


def kernel_phase(dev):
    import torch.nn.functional as F

    from seedvr2_tpu_torch.config import dit_3b
    from seedvr2_tpu_torch.models.dit.nadit import build_attn_plans, device_plans
    from seedvr2_tpu_torch.ops import conv3d_kernel as k1
    from seedvr2_tpu_torch.ops import fold_upsample_kernel as k2
    from seedvr2_tpu_torch.ops import fused_window_attention as k3

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
        rows.append(compare(
            f"conv3d_3x3x3 c{c} {T}x{H}x{W}", "cuda", "seedvr2_tpu_torch/csrc/conv3d.cuh",
            "seedvr2_tpu/ops/conv3d_kernel.py:193",
            lambda: k1.conv3d_3x3x3(x, w, b), lambda: k1.conv3d_3x3x3_plain(x, w, b),
            lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), w_oidhw, b.bfloat16(), padding=(0, 1, 1)),
        ))
        del x
    # K2: the decoder's three upsamples at 720p (the phase-pure call of each)
    for c, kt, A, Tin, H, W in ((512, 2, 2, 2, 90, 160), (512, 2, 2, 3, 180, 320), (256, 3, 1, 7, 360, 640)):
        x = randn(1, Tin, H, W, c)
        K = randn(kt, 2, 2, c, A * 4 * c, scale=(kt * 4 * c) ** -0.5)
        btab = torch.randn(2, 2, A * 4 * c, generator=g, device=dev)
        bc = torch.randn(c, generator=g, device=dev)
        rows.append(compare(
            f"fold_upsample_conv c{c} kt{kt} A{A} {Tin}x{H}x{W}", "cuda", "seedvr2_tpu_torch/csrc/fold_upsample.cuh",
            "seedvr2_tpu/ops/fold_upsample_kernel.py:116",
            lambda: k2.fold_upsample_conv(x, K, btab, bc, A), lambda: k2.fold_upsample_conv_plain(x, K, btab, bc, A),
        ))
    # K3: 3B geometry at 720p output, patched latent (2, 45, 80), Lt = 58
    cfg = dit_3b()
    for which, dp in zip(("plain", "shifted"), device_plans(build_attn_plans(cfg, (2, 45, 80), 58), cfg.head_dim, dev)):
        nW, S = dp.valid.shape
        vqkv = randn(1, 3, cfg.heads, nW, S, cfg.head_dim)
        tqkv = randn(1, 3, cfg.heads, 58, cfg.head_dim)
        norms = 1 + 0.1 * torch.randn(4, cfg.head_dim, generator=g, device=dev)
        args = (vqkv, tqkv, dp.vid_cos, dp.vid_sin, dp.txt_cos, dp.txt_sin, dp.valid, dp.rope_txt, norms, True, cfg.norm_eps)
        rows.append(compare(
            f"fused_window_attention {which} H{cfg.heads} nW{nW} S{S} Lt58", "cuda",
            "seedvr2_tpu_torch/csrc/window_attention.cuh", "seedvr2_tpu/ops/fused_window_attention.py:145",
            lambda: k3.fused_window_attention(*args), lambda: k3.fused_window_attention_plain(*args),
        ))
    return rows


def small_config():
    from seedvr2_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig

    vae = VAEConfig(block_out_channels=(128, 128, 256, 256), layers_per_block=1)
    dit = DiTConfig(variant="small", vid_dim=256, txt_dim=256, emb_dim=6 * 256, heads=2, num_layers=2, mm_layers=1,
                    swiglu_multiple_of=64, sinusoidal_dim=64)
    return PipelineConfig(dit=dit, vae=vae, resolution=64)


def reference_phase(dev, text):
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
        cfg = small_config().replace(compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
        dit = init_random(NaDiT(cfg.dit, device, dtype), torch.Generator().manual_seed(11))
        vae = init_random(VAE(cfg.vae, device, dtype), torch.Generator().manual_seed(12))
        noise = torch.randn((2, 8, 12, 16), generator=torch.Generator().manual_seed(13))
        outs.append(phases.generate(Runner(cfg, dit, vae, text, device=device), frames, noise=noise))
    gpu, cpu = outs
    mean_err = float(np.abs(gpu - cpu).mean())
    rel = float(np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu - 0.5))
    print(f"  small config: out {gpu.shape}, mean |gpu bf16 - cpu fp32| {mean_err:.3e}, rel L2 {rel:.3e}", flush=True)
    if not (gpu.shape == (5, 64, 96, 3) and np.isfinite(gpu).all() and mean_err <= 1e-2 and rel <= 5e-2):
        raise RuntimeError(f"small config: card and CPU disagree (mean {mean_err:.3e}, rel {rel:.3e})")


def main_path_phase(dev, text):
    from seedvr2_tpu_torch.config import PipelineConfig
    from seedvr2_tpu_torch.io.weights import random_dit, random_vae
    from seedvr2_tpu_torch.ops import conv3d_kernel as k1
    from seedvr2_tpu_torch.ops import fold_upsample_kernel as k2
    from seedvr2_tpu_torch.ops import fused_window_attention as k3
    from seedvr2_tpu_torch.pipeline import phases
    from seedvr2_tpu_torch.pipeline.runner import Runner

    cfg = PipelineConfig(resolution=720)  # 3B, bf16, wavelet, batch 5, untiled VAE, 16-bit out
    g = torch.Generator(device=dev).manual_seed(42)
    t0 = time.perf_counter()
    runner = Runner(cfg, random_dit(cfg.dit, g), random_vae(cfg.vae, g), text, device=dev)
    torch.cuda.synchronize()
    print(f"  weights on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    frames = np.random.RandomState(7).randint(0, 256, (5, 360, 640, 3)).astype(np.uint8)

    kernels = (k1.conv3d_3x3x3, k2.fold_upsample_conv, k3.fused_window_attention)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = phases.generate(runner, frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30

    t0 = time.perf_counter()
    phases.generate(runner, frames)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    print(f"  main path: out {out.shape} {out.dtype}, first run {wall:.3f} s, second run {wall2:.3f} s, "
          f"peak {peak:.2f} GiB, launches {launches}", flush=True)
    if out.shape != (5, 720, 1280, 3) or not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise RuntimeError(f"main path: bad output {out.shape}")
    if float(out.std()) == 0.0:
        raise RuntimeError("main path: constant output")
    if min(launches.values()) == 0:
        raise RuntimeError(f"main path: a kernel never launched: {launches}")
    if launches["fused_window_attention"] != cfg.dit.num_layers:
        raise RuntimeError(f"main path: K3 ran {launches['fused_window_attention']} times, expected {cfg.dit.num_layers}")
    return launches, {"wall_s": wall, "second_run_wall_s": wall2, "peak_gib": peak}


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
    print("[4] small config: card vs CPU", flush=True)
    reference_phase(dev, text)

    print("[5] main path: 3B + VAE, 5 x 640x360 -> 1280x720", flush=True)
    launches, e2e = main_path_phase(dev, text)
    for row in rows:
        row["launches"] = launches[row["name"].split()[0]]
    print(json.dumps({"kernels": rows, "e2e": e2e, "build_s": b.seconds}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
