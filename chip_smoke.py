#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises and the script exits non-zero without a result):
  1. card: name, power limit, versions;
  2. build: compile csrc/ with nvcc for sm_90a (build time, -Xptxas -v);
  3. kernels: seedvr2_tpu_torch/conv_ab.py's rows on this tree, one
     round (``conv_ab.run``): every kernel at the main paths' shapes,
     called through the program's wrapper, against its plain version (rel
     L2 <= 1e-2, finite, the same bits on a second call, conv_ab's own
     launch of the C entry bit-equal to the wrapper's), with its ms, the
     plain version's, the nearest library call's and its bound; a row's
     ``launches`` is filled at the end from the driven run that gives its
     shape (its ``path``: "720p" phase 5's counts, with K4 and K8 from its
     GroupNorm-fusion run and K3q, K5 and K11 from phase 6's runs;
     "long_clip" phase 7's; a K7 row its own shape's count in its model's
     phase-10 batch; None, a shape no driven run gives, stays null); the
     card tests, tests/test_torch_kernels_gpu.py, hold each kernel at its
     edges;
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
     settings through seedvr2_tpu_torch.pipeline.phases.generate (every
     GroupNorm on K8 + K9: 52 each); then the same with the VAE's
     GroupNorm fusion on (K4 48 launches, K1 none, K8 52, K9 4); on
     both routes the encoder's and the decoder's mid attention on K10
     (2 launches);
  6. the 7B path: NaDiT-7B (36 layers, width 3072, 24 heads) and the VAE at
     full width, the same clip, once under sageattn_2 (K3q in every layer)
     and once under flash_attn_2 (K11 then K5 in every layer);
  7. the long-clip path: NaDiT-3B and the VAE at full width, a 15-frame
     960x540 clip upscaled to 1920x1080 through the 4-phase pipeline:
     batch_size 9 with temporal_overlap 3 (two batches, Hann blend), the
     tiled VAE at its default tiles (2x2 in encode and decode), GroupNorm
     fusion on (K4 in every resnet conv), wavelet colour;
  8. the multi-rank path, two ranks on the one card (parallel/launch.py,
     gloo: NCCL refuses two ranks on one device, so tensors between ranks
     go through host memory; the kernels run on the card). First, in this
     process, K3s rank by rank at full width: 3B 720p plain (nW 18) and
     shifted (nW 32) and 3B 1080p plain (nW 75, a padded tail window) on
     seq=2, 3B 720p H20 and 7B 720p K3q H24 on tensor=2; each rank's range
     against the matching slice of the unsharded K3 / K3q launch (rel L2 <=
     1e-2) and the ranks' outputs assembled against the plain version (rel
     L2 <= 1e-2; K3q's step share within 0.1 of 1: <k - r, p - r> / <p -
     r, p - r> against the unquantised attention r), with its time, its
     plain version's and SDPA's on the same shard, and its bound
     (conv_ab.bound); K5 at each rank's shapes of the 3B 720p plain plan
     under flash_attn_2 on seq=2 (9 windows a rank) and tensor=2 (10 heads
     a rank) against its plain version (rel L2 <= 1e-2, two launches the
     same bits), timed the same way. Then, in the two ranks: the 3B DiT step
     at the 720p latent under (1,2,1) and (1,1,2), under fused and under
     flash_attn_2 (the unfused window path, K5 per rank), and at the 1080p
     latent under (1,2,1), and the 7B step under sageattn_2 on (1,1,2)
     (K3q per rank), each against the unsharded step on the same rank in
     the same mode (rel L2 <= 5e-2, the bound of the card checks);
     generate_multichip with data=2 on 10 x 640x360 -> 1280x720 frames
     (one 5-frame segment a rank, seam overlap 0, untiled VAE) against
     rank 0's single-rank phases.generate of the same frames (mean |diff|
     <= 1e-2, rel L2 <= 5e-2 as phase 4); and generate_multichip with 3 of
     those frames, under 2 a rank, so both ranks run phases.generate with
     the tile-parallel VAE (512 px tiles, a 2 x 3 grid, 3 tiles a rank,
     fp32 accumulators summed through host memory), against rank 0's
     single-rank tiled run (same bounds; the ranks' K1 and K2 launches
     must add up to the single run's: every tile ran once).
  9. the CLI: seedvr2_tpu_torch/cli.py's argv in this process at full
     width (3B + VAE, bf16) through safetensors that the port wrote,
     640x360 -> 1280x720: an image, an RGBA image, 12 frames in chunks of
     5 overlapping by 3, --resume, the noise flags, yuv420 planes and
     planar input, cfg_scale 2. Each output against phases.generate on the
     same decoded frames (with the same host seam blend), max |diff| 0
     codes; K1, K2 and K3 against phase 5's counts a batch times the
     batches (an image's against phases.generate's on it); planar input
     against the planes converted on the card first (0 codes); the
     cfg_scale 2 step against neg + 2 (pos - neg) of two unguided steps
     (rel L2 <= 1e-2).
 10. int8 weights (K7, the W8A16 linear): NaDiT-7B with quantize="int8"
     (weights drawn and quantized on the card) under sageattn_2 and the
     VAE, 5 x 640x360 -> 1280x720 through phases.generate, two runs, K7 =
     int8_linear_calls (288) and K3q = 36 launches; its DiT step against a
     bf16 7B with the same int8 leaves dequantized (rel L2 <= 5e-2) and,
     for information, against the unquantized bf16 step on the same draws;
     then NaDiT-3B through the CLI's argv in this process, --quantize int8
     from phase 9's safetensors and a .gguf (Q8_0 block linears) that
     io/gguf.py writes from the same weights: each output against
     phases.generate on the runner the CLI loaded (max |diff| 0 codes),
     K7 = int8_linear_calls (317) and phase 5's K1, K2, K3 a batch, block 0's
     qkv bit-equal to the file's weight quantized; the GGUF's write and
     read + dequantize seconds. K7 runs in two regimes, chosen by its row
     count (ops/quant.py:regime): wgmma for the video rows, split-K for the
     text rows; the 7B batch must take both (K7_wgmma + K7_splitk = K7),
     and the 7B batch and each 3B CLI run K7 at each of their linears'
     shapes at the video rows (M 7200) and the text rows (M 58)
     (read_counts' "K7_shapes").
 11. the ComfyUI node layer (seedvr2_tpu_torch/interfaces.py) under the
     stub host of tests/comfy_stub.py (installed through a
     pytest.MonkeyPatch and undone at the end), 3B + VAE from phase 9's
     safetensors: (a) the V3 workflow (loader nodes with cache_model, the
     upscaler) on the phase-5 clip as a ComfyUI IMAGE, its output a CPU
     float32 tensor equal to phases.generate's on the same runner (max
     |diff| 0), K1, K2 and K3 = phase 5's, the progress bar monotone to
     100; (b) a second execute with color_correction="lab": no load, equal
     to phases.generate under that config; (c) 10 frames in two batches,
     the interrupt flag set from the first progress update and then from
     the first after a batch: InterruptProcessingException, and no launch
     after the flag; (d) the 3B 1920x1080 batch (phase 7's geometry): the
     peaks of its stages, then phases.generate under
     torch.cuda.set_per_process_memory_fraction(PHASE11_MEMORY_FRACTION):
     the fused route falls back and the 4-phase route's VAE climbs the
     ladder (each rung printed), 0 codes from the run at the tiles it
     reached; the cap lifted in a finally; (e) on that batch's latent, the
     host-staged decode against the device-tiled one at 512 px tiles (rel
     L2 <= 1e-3, PSNR, time and a lower peak).
 12. the streamed output path: 3B + VAE at full width (random bf16
     weights, wavelet, 16-bit codes), phases.generate on the column-chunk
     route (chunked_output "auto") against one fused_batch a batch
     ("off"), two runs each, every batch asserted on its route: (a) the
     main path's clip with decode_tiled at 1024 / 128 px (the plan asserted:
     columns (0, 72), chunk ends (544, 1280)), (b) 960x540 -> 1920x1080 at
     1088 x 1024 px tiles ((0, 112), (864, 1920)): wall, peak, codes within
     2, K1 / K2 / K3 / K8 / K9 equal on both routes and non-zero; (c) 15 frames in
     three batches under torch.profiler: the device -> host copies' bytes
     and ms, the ms of them under a compute-stream kernel, and the
     synchronizing calls of each route
     (torch.cuda.set_sync_debug_mode); (d) (a) with yuv420 planes, within
     1 code.
 13. the load path's cold start: load_runner through the weights cache
     (io/native_ckpt.py; the streamed conversion of io/weights.py) on
     phase 9's 3B fp16 safetensors and VAE, linked into a fresh directory:
     (a) a cold load (converted, the cache written) and (b) a warm one
     (the cache read), each in a child process that imports only
     seedvr2_tpu_torch (seedvr2_tpu_torch/load_probe.py): wall,
     ru_maxrss, peak RssAnon, the cache's bytes; (d) os.utime on the
     source makes the next load cold again: (c) in this process that cold
     load and a warm one, every DiT and VAE tensor bit-equal (buffers, K1's
     layout, K2's folds), one phases.generate batch of the main path's
     clip from each, 0 codes apart, K1, K2, K3, K8 and K9 = phase 5's a batch.
     Phase 10 holds its two int8 DiTs (--quantize int8, the .gguf) the
     same way, cold against warm. Phase 9's first CLI run is the cold load
     of its files; phases 10 (the VAE) and 11 load them warm.
Budgets (H100 80GB HBM3, 700 W; PERF.md): the whole script ~630 s (627 s
measured), of it phase 9 ~115-130 s (its first run converts), phase 10
~190-240 s, phase 11 ~17-40 s (warm loads), phase 12 ~27-60 s and phase
13 ~105-140 s; it must end within 1200 s. K7 may launch only in phases 3
and 10 (read_counts raises elsewhere). Every launch counter is set to 0 right before each
driven run of phases 5, 6 and 7 and read right after it; phase 7's counts
also stand under ``e2e.long_clip.launches``; a phase-8 row's
``launches`` is its rank's count in the phase-8 run of its path (K3s over
K3 or over K3q, or K5, per rank). Every expect of phases 4-13 that runs
the VAE counts K8 and K9 too. The VAE's stage times are the program's own
``runner.vae_encode`` / ``runner.vae_decode`` ranges
(``python -m seedvr2_tpu_torch.profile_batch``, ``portbench --trace 1``).
Then: the JSON line (phase 3's rows and phase 8's rank rows under "kernels", the end-to-end
results, the small configs, the build times), the card line, and the
final JSON line.
"""

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_counters():
    from seedvr2_tpu_torch.ops import conv3d_kernel as k1
    from seedvr2_tpu_torch.ops import flash_attention as k5
    from seedvr2_tpu_torch.ops import fold_upsample_kernel as k2
    from seedvr2_tpu_torch.ops import fused_window_attention as k3
    from seedvr2_tpu_torch.ops import mid_attention as k10
    from seedvr2_tpu_torch.ops import normalization as norm
    from seedvr2_tpu_torch.ops import quant
    from seedvr2_tpu_torch.ops import window_prepare as k11

    return {
        "K1": (k1.conv3d_3x3x3, "launches"),
        "K2": (k2.fold_upsample_conv, "launches"),
        "K3": (k3.fused_window_attention, "launches"),
        "K3q": (k3.fused_window_attention, "launches_int8"),
        "K5": (k5.flash_attention, "launches"),
        "K11": (k11.window_prepare, "launches"),
        "K4": (k1.conv3d_3x3x3, "launches_gn"),
        "K8": (k1.gn_silu_tables, "launches"),
        "K9": (norm.gn_apply, "launches"),
        "K10": (k10.mid_attention, "launches"),
        "K3s": (k3.fused_window_attention_sharded, "launches"),
        "K3s_int8": (k3.fused_window_attention_sharded, "launches_int8"),
        "K7": (quant.linear_apply, "launches"),
        "K7_wgmma": (quant.linear_apply, "launches_wgmma"),
        "K7_splitk": (quant.linear_apply, "launches_splitk"),
    }


def k7_shape(M, K, N) -> str:
    return f"M{M} K{K} N{N}"


def reset_counts():
    from seedvr2_tpu_torch.ops import quant

    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)
    quant.reset_launches()  # and K7's counts by shape


# the counts a batch of phase 5's clip fixes on the default (unfused) route: K8 and K9 run every GroupNorm of
# the VAE there (the 48 resnets', K1's count, + norm_out and the mid attention's in the encoder and the decoder)
PER_BATCH = ("K1", "K2", "K3", "K8", "K9")
# K7 runs int8 weights only: a driven run outside phase 10 that launches it leaks int8 into a bf16 path
INT8_RUNS = {"allowed": False}


def read_counts():
    """Every kernel's count, and K7's by shape under "K7_shapes" (k7_shape: n)."""
    from seedvr2_tpu_torch.ops import quant

    counts = {kid: getattr(fn, attr) for kid, (fn, attr) in kernel_counters().items()}
    if counts["K7"] and not INT8_RUNS["allowed"]:
        raise RuntimeError(f"K7 launched {counts['K7']} times in a run of bf16 weights")
    counts["K7_shapes"] = {k7_shape(*key): n for key, n in quant.linear_apply.launches_by_shape.items()}
    return counts


def _rel(got_t, ref_t):
    return max(float((g - r).norm() / r.norm()) for g, r in zip(got_t, ref_t))


def int8_linear_calls(dit) -> int:
    """K7 launches in one forward of an int8 NaDiT: each layer's qkv and
    out projections run for the video and the text stream (a shared layer's
    'all' weights twice), its MLP's 2 (GELU) or 3 (SwiGLU) linears for the
    video stream and, unless the layer is video-only, the text stream; only
    the int8 ones count."""
    from seedvr2_tpu_torch.ops import quant

    n = 0
    for blk in dit.blocks:
        n += sum(2 * quant.is_quantized(next(iter(group.values())).spec) for group in (blk.attn.qkv, blk.attn.out))
        mlp = next(iter(blk.mlp.values()))
        lin = [mlp.proj_in, mlp.proj_out] + ([mlp.proj_in_gate] if mlp.swiglu else [])
        n += (1 if blk.vid_only else 2) * sum(quant.is_quantized(m.spec) for m in lin)
    return n


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
    if ran["K11"] != (ran["K5"] if mode == "flash_attn_2" else 0):
        raise RuntimeError(f"{label}: K11 ran {ran['K11']} times beside K5's {ran['K5']}")
    # every GroupNorm through K8: the resnets' (K1's or K4's count), norm_out and the mid attention's, which K9
    # applies (with K4, only those four)
    if long_clip and not (ran["K4"] > 0 and ran["K1"] == 0 and ran["K9"] > 0 and ran["K8"] == ran["K4"] + ran["K9"]):
        raise RuntimeError(f"{label}: expected K4, K9, K8 = K4 + K9 and no K1 launches, got {ran}")
    if not long_clip and not (ran["K4"] == 0 and ran["K1"] > 0 and ran["K8"] == ran["K9"] == ran["K1"] + 4):
        raise RuntimeError(f"{label}: expected K1 and K8 = K9 = K1 + 4 launches, got {ran}")
    gpu, cpu = outs
    mean_err = float(np.abs(gpu - cpu).mean())
    rel = float(np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu - 0.5))
    print(f"  {label}: out {gpu.shape}, mean |gpu bf16 - cpu fp32| {mean_err:.3e}, rel L2 {rel:.3e}, "
          f"launches {ran}", flush=True)
    if not (gpu.shape == (n, 64, 96, 3) and np.isfinite(gpu).all() and mean_err <= 1e-2 and rel <= 5e-2):
        raise RuntimeError(f"{label}: card and CPU disagree (mean {mean_err:.3e}, rel {rel:.3e})")
    return {"rope_type": rope_type, "mode": mode, "long_clip": long_clip, "mean_abs_diff": mean_err, "rel_l2": rel}


def drive(runner, frames, label, out_shape=(5, 720, 1280, 3), runs=2):
    """One counted run (counters reset right before, read right after),
    then with ``runs=2`` a second run for the steady wall time."""
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
    print(f"  {label}: out {out.shape} {out.dtype}, first run {wall:.3f} s{note}, peak {peak:.2f} GiB, "
          f"launches {launches}", flush=True)
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


def kernel_phase(dev):
    """Phase 3: conv_ab's rows on this tree alone, one round."""
    from seedvr2_tpu_torch import conv_ab
    from seedvr2_tpu_torch.ops import cuda_lib

    return conv_ab.run(conv_ab.Bench({"this": cuda_lib.library()}, {}, 1, dev))


def fill_launches(rows, counts: dict, int8: dict):
    """Each phase-3 row's ``launches``: ``counts[path][kernel]``; a K7 row's,
    its own shape's count in ``int8[model]``'s batch (at least one)."""
    for row in rows:
        if row["path"] is None:
            continue  # a shape that no driven run gives: timed alone, launches null
        if row["kernel"] == "K7":
            row["launches"] = int8[row["model"]]["K7_shapes"].get(k7_shape(*row["mkn"]), 0)
            if row["launches"] == 0:
                raise RuntimeError(f"{row['name']}: phase 10's {row['model']} batch never ran K7 at this shape")
        else:
            row["launches"] = counts[row["path"]][row["kernel"]]


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
    # 48 resnet convs (20 in the encoder, 28 in the decoder); K2 per decoder upsample and latent slice; K8 then K9
    # for each GroupNorm: the 48 resnet convs' inputs, and norm_out and the mid attention's in each half (+ 4)
    # K10: the encoder's and the decoder's mid attention, every frame of each in one launch
    expect("3B fused", launches, {"K1": 48, "K2": 6, "K3": cfg.dit.num_layers, "K3q": 0, "K5": 0, "K4": 0, "K8": 52,
                                  "K9": 52, "K10": 2})
    # the same path with the resnets' GroupNorm + SiLU folded into their convs
    runner.vae.set_gn_fusion(True)
    launches_gn, e2e_gn = drive(runner, frames, "3B fused gn_fusion")
    # K8: the tables of each K4 conv's input, one launch a conv, and of the 4 GroupNorms outside K4, which K9 applies
    expect("3B fused gn_fusion", launches_gn, {"K4": 48, "K8": 52, "K9": 4, "K1": 0, "K2": 6,
                                               "K3": cfg.dit.num_layers, "K10": 2})
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
    # 2 batches x (20 resnet convs x 2 encode slices + 28 x 2 decode slices) x 4 tiles; 32 layers x 2 batches; K9:
    # norm_out and the mid attention's GroupNorm in each of those 32 encoder and decoder calls, K8 their tables too
    expect("3B long clip", launches, {"K4": 768, "K8": 832, "K9": 64, "K1": 0, "K2": 72, "K3": 64, "K3q": 0,
                                      "K5": 0, "K10": 32})  # K10: one launch a mid attention, half of K9's
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
    # the 3B's VAE, unfused
    expect("7B sageattn_2", launches, {"K3q": n, "K3": 0, "K5": 0, "K11": 0, "K8": 52, "K9": 52, "K10": 2})
    runner.dit.set_attention_mode("flash_attn_2")
    launches_f, out["flash_attn_2"] = drive(runner, frames, "7B flash_attn_2")
    expect("7B flash_attn_2", launches_f, {"K5": n, "K11": n, "K3": 0, "K3q": 0, "K8": 52, "K9": 52, "K10": 2})
    return launches, launches_f, out


# --------------------------------------------------------------------------- #
# Phase 8: the multi-rank path
# --------------------------------------------------------------------------- #

# (label, cfg factory, patched latent, plan, seq, tensor, quant_qk, phase-8 run whose count the rows carry)
K3S_CASES = [
    ("3B 720p plain", "dit_3b", (2, 45, 80), 0, 2, 1, False, "seq_720p"),
    ("3B 720p shifted", "dit_3b", (2, 45, 80), 1, 2, 1, False, "seq_720p"),
    ("3B 1080p plain", "dit_3b", (3, 68, 120), 0, 2, 1, False, "seq_1080p"),
    ("3B 720p plain", "dit_3b", (2, 45, 80), 0, 1, 2, False, "tensor_720p"),
    ("7B 720p plain", "dit_7b", (2, 45, 80), 0, 1, 2, True, "7b_tensor"),
]
# (tile, overlap) in pixels of phase 8's tile-parallel encode and decode: a 2 x 3 grid at 1280x720
PHASE8_TILE = ((512, 512), (64, 64))


def _k3s_rows(dev, g):
    """K3s per rank (no collective inside, so each rank's call is made here,
    one after another, with the card to itself while it is timed)."""
    import torch.nn.functional as F

    from seedvr2_tpu_torch import config
    from seedvr2_tpu_torch.conv_ab import REL_BOUND, bound, cuda_ms, nbytes
    from seedvr2_tpu_torch.models.dit.nadit import build_attn_plans, device_plans
    from seedvr2_tpu_torch.ops import fused_window_attention as k3

    rows = []
    for label, factory, thw, which, seq, tensor, quant, path in K3S_CASES:
        cfg = getattr(config, factory)()
        H, D, Lt = cfg.heads, cfg.head_dim, 58
        dp = device_plans(build_attn_plans(cfg, thw, Lt), D, dev)[which]
        nW, S = dp.valid.shape
        vqkv = torch.randn((1, 3, H, nW, S, D), generator=g, device=dev).bfloat16()
        tqkv = torch.randn((1, 3, H, Lt, D), generator=g, device=dev).bfloat16()
        norms = 1 + 0.1 * torch.randn(4, D, generator=g, device=dev)
        tables = (dp.vid_cos, dp.vid_sin, dp.txt_cos, dp.txt_sin, dp.valid, dp.rope_txt, norms, True, cfg.norm_eps)
        full_k = k3.fused_window_attention(vqkv, tqkv, *tables, quant_qk=quant)
        full_p = k3.fused_window_attention_plain(vqkv, tqkv, *tables, quant_qk=quant)
        rival = k3.fused_window_attention_plain(vqkv, tqkv, *tables, quant_qk=False) if quant else None
        hl = H // tensor
        parts = {}
        for r in range(seq * tensor):
            s_rank, t_rank = r // tensor, r % tensor
            hs = slice(t_rank * hl, (t_rank + 1) * hl)
            v_r, t_r = vqkv[:, :, hs].contiguous(), tqkv[:, :, hs].contiguous()
            first, end, per = k3.window_range(nW, seq, s_rank)
            cos, sin, valid = k3.shard_window_tables(dp.vid_cos, dp.vid_sin, dp.valid, s_rank, seq)
            loc = (cos, sin, dp.txt_cos, dp.txt_sin, valid, dp.rope_txt, norms, True, cfg.norm_eps)
            v_loc = k3.pad_windows(v_r[:, :, :, first:end], 3, per, 0.0)

            def kernel():  # the rank's windows already gathered, as the DiT hands them over
                return k3.fused_window_attention_sharded(v_loc, t_r, *tables, quant_qk=quant, seq_rank=s_rank,
                                                         seq_size=seq)

            ov, ot = kernel()
            torch.cuda.synchronize()
            n = end - first
            vs_unsharded = max(_rel((ov[:, :, :n].float(),), (full_k[0][:, hs, first:end].float(),)),
                               _rel((ot[:, :, :n].float(),), (full_k[1][:, hs, first:end].float(),)))
            if not vs_unsharded <= REL_BOUND:
                raise RuntimeError(f"K3s {label} rank {r}: differs from the unsharded launch (rel L2 {vs_unsharded:.3e})")
            parts[(s_rank, t_rank)] = (ov[:, :, :n], ot[:, :, :n])
            keys = int(valid.sum()) + per * Lt  # the rank's valid video keys and every window's text keys
            qk = 2 * hl * (S + Lt) * keys * D
            ops = {"int8": qk, "bf16": qk} if quant else {"bf16": 2 * qk}
            moved = nbytes(v_loc, t_r, valid, norms, cos, sin) + (nbytes(dp.txt_cos, dp.txt_sin) if dp.rope_txt else 0)
            moved += 2 * hl * per * (S + Lt) * D  # bf16 outputs
            q, k, v = (torch.cat([v_loc[0, i].permute(1, 0, 2, 3), t_r[0, i][None].expand(per, hl, Lt, D)], dim=2)
                       for i in range(3))
            mask = torch.cat([valid, torch.ones(per, Lt, dtype=torch.bool, device=dev)], dim=1)[:, None, None]
            bound_ms, bound_by = bound(moved, ops)
            row = {
                "name": f"K3s {label} H{H} nW{nW} S{S} Lt{Lt} seq {s_rank}/{seq} tensor {t_rank}/{tensor} "
                        f"(windows {first}-{end - 1}{' + pad' if per > n else ''}, heads {hs.start}-{hs.stop - 1})"
                        + (" K3q" if quant else ""),
                "kernel": "K3s", "route": "cuda",
                "source": "seedvr2_tpu_torch/ops/fused_window_attention.py (K3s) on "
                          "seedvr2_tpu_torch/csrc/window_attention.cuh",
                "replaces": "seedvr2_tpu/ops/fused_window_attention.py:214",
                "launches": None, "max_abs_err": None, "rel_l2_vs_unsharded_kernel": vs_unsharded,
                "ms": cuda_ms(kernel, 20),
                "plain_ms": cuda_ms(lambda: k3.fused_window_attention_plain(v_loc, t_r, *loc, quant_qk=quant), 3),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20),
                "library_call": "F.scaled_dot_product_attention on the rank's shard: pre-normed, pre-roped q/k/v "
                                "[per_rank, H/t, S+Lt, D] with the key mask",
                "path": path, "rank": r, "quant_qk": quant,
            }
            rows.append(row)
            del q, k, v, mask, v_loc
        # the ranks' outputs assembled (real windows, every head) against the plain version
        got = tuple(torch.cat([torch.cat([parts[(s, t)][i] for t in range(tensor)], 1) for s in range(seq)], 2).float()
                    for i in range(2))
        ref = tuple(x.float() for x in full_p)
        rel = _rel(got, ref)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        note = ""
        if quant:
            riv = tuple(x.float() for x in rival)
            step = sum(float(((a - b) * (a - b)).sum()) for a, b in zip(ref, riv))
            share = sum(float(((a - v) * (b - v)).sum()) for a, b, v in zip(got, ref, riv)) / step
            note = f", step share {share:.4f}"
            if not abs(share - 1.0) <= 0.1:
                raise RuntimeError(f"K3s {label}: the ranks do not reproduce K3q's int8 step (share {share:.4f})")
            for row in rows[-seq * tensor:]:
                row["step_share"] = share
        if not (rel <= REL_BOUND and all(bool(torch.isfinite(x).all()) for x in got)):
            raise RuntimeError(f"K3s {label}: assembled ranks disagree with the plain version (rel L2 {rel:.3e})")
        for row in rows[-seq * tensor:]:
            row.update(max_abs_err=err, rel_l2=rel)
            print(f"  {row['name']}: vs unsharded kernel rel L2 {row['rel_l2_vs_unsharded_kernel']:.3e}, assembled "
                  f"vs plain rel L2 {rel:.3e} max|err| {err:.3e}{note}  kernel {row['ms']:.3f} ms  plain "
                  f"{row['plain_ms']:.3f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})  SDPA "
                  f"{row['library_ms']:.3f} ms", flush=True)
        del vqkv, tqkv, full_k, full_p, rival, parts, got, ref
    return rows


def _k5_rank_rows(dev, g):
    """K5 at each rank's shapes under flash_attn_2, the 3B 720p plain plan:
    seq=2 (the rank's windows, padded to ceil(nW/2), every head) and
    tensor=2 (every window, half the heads), against its plain version (rel
    L2 <= REL_BOUND), two launches the same bits, with SDPA on the same
    shard and the bound."""
    import torch.nn.functional as F

    from seedvr2_tpu_torch.config import dit_3b
    from seedvr2_tpu_torch.conv_ab import REL_BOUND, bound, cuda_ms, nbytes
    from seedvr2_tpu_torch.models.dit.nadit import build_attn_plans, device_plans
    from seedvr2_tpu_torch.ops import flash_attention as k5
    from seedvr2_tpu_torch.ops import fused_window_attention as k3

    cfg = dit_3b()
    H, D, Lt = cfg.heads, cfg.head_dim, 58
    dp = device_plans(build_attn_plans(cfg, (2, 45, 80), Lt), D, dev)[0]
    nW, mL = dp.valid.shape
    S = mL + Lt
    rows = []
    for seq, tensor, path in ((2, 1, "seq_720p_flash"), (1, 2, "tensor_720p_flash")):
        hl = H // tensor
        for r in range(seq * tensor):
            s_rank, t_rank = r // tensor, r % tensor
            first, end, per = k3.window_range(nW, seq, s_rank)
            valid = k3.shard_window_tables(dp.vid_cos, dp.vid_sin, dp.valid, s_rank, seq)[2]
            kv_valid = torch.cat([valid, torch.ones(per, Lt, dtype=torch.bool, device=dev)], dim=1).contiguous()
            q, k, v = (torch.randn((per, S, hl, D), generator=g, device=dev).bfloat16() for _ in range(3))
            name = (f"K5 3B 720p plain B{per} S{S} H{hl} seq {s_rank}/{seq} tensor {t_rank}/{tensor} (windows "
                    f"{first}-{end - 1}{' + pad' if per > end - first else ''}, heads {t_rank * hl}-"
                    f"{(t_rank + 1) * hl - 1})")
            o, ref = k5.flash_attention(q, k, v, kv_valid), k5.flash_attention_plain(q, k, v, kv_valid)
            rel = _rel((o.float(),), (ref.float(),))
            if not (rel <= REL_BOUND and bool(torch.isfinite(o).all())):
                raise RuntimeError(f"{name}: kernel disagrees with its plain version (rel L2 {rel:.3e})")
            if not torch.equal(o, k5.flash_attention(q, k, v, kv_valid)):
                raise RuntimeError(f"{name}: two launches on the same inputs differ")
            qt, kt, vt, mask = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_valid[:, None, None]
            qk = 2 * hl * S * int(kv_valid.sum()) * D  # every query row against the valid keys of its batch row
            bound_ms, bound_by = bound(nbytes(q, k, v, kv_valid, o), {"bf16": 2 * qk})
            row = {
                "name": name, "kernel": "K5", "route": "cuda", "source": "seedvr2_tpu_torch/csrc/flash_attention.cuh",
                "replaces": "seedvr2_tpu/ops/flash_attention.py:96", "launches": None,
                "max_abs_err": float((o.float() - ref.float()).abs().max()), "rel_l2": rel,
                "ms": cuda_ms(lambda: k5.flash_attention(q, k, v, kv_valid), 20),
                "plain_ms": cuda_ms(lambda: k5.flash_attention_plain(q, k, v, kv_valid), 3),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 20),
                "library_call": "F.scaled_dot_product_attention on the rank's [B, H, S, D] views with the key mask",
                "path": path, "rank": r, "quant_qk": False,
            }
            print(f"  {name}: rel L2 {rel:.3e}  kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  bound "
                  f"{bound_ms:.4f} ms ({bound_by})  SDPA {row['library_ms']:.3f} ms", flush=True)
            rows.append(row)
            del q, k, v, o, ref
    return rows


def _phase8_step(runner, latent, seed):
    """One counted DiT step (counters reset right before, read right after)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = runner.upscale(latent, seed)
    torch.cuda.synchronize()
    return out.float(), read_counts(), time.perf_counter() - t0


def _check_step(label, got, ref):
    rel = float((got - ref).norm() / ref.norm())
    if not (torch.isfinite(got).all() and rel <= 5e-2):
        raise RuntimeError(f"{label}: sharded step differs from the unsharded one (rel L2 {rel:.3e})")
    return rel


def _phase8_rank(rank, text, frames, device="cuda:0"):
    """One of the two ranks of phase 8 (started by parallel/launch.py); both
    on ``device``, the one card."""
    import torch.distributed as dist

    from seedvr2_tpu_torch.config import PipelineConfig, pipeline_7b
    from seedvr2_tpu_torch.io.weights import random_dit, random_vae
    from seedvr2_tpu_torch.parallel.mesh import make_mesh
    from seedvr2_tpu_torch.parallel.sharding import shard_dit
    from seedvr2_tpu_torch.pipeline import phases
    from seedvr2_tpu_torch.pipeline.multichip import generate_multichip
    from seedvr2_tpu_torch.pipeline.runner import Runner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    meshes = {shape: make_mesh(*shape, device=dev) for shape in ((1, 2, 1), (1, 1, 2), (2, 1, 1))}
    report = {"rank": rank, "runs": {}}

    def latent(shape, seed):
        return torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev).bfloat16()

    def run(key, runner, lat, ref, want):
        out, counts, wall = _phase8_step(runner, lat, 5)
        rel = _check_step(key, out, ref)
        expect(f"rank {rank} {key}", counts, want)
        report["runs"][key] = {"launches": counts, "rel_l2": rel, "wall_s": wall}
        print(f"  rank {rank} {key}: rel L2 to the unsharded step {rel:.3e}, {wall:.2f} s, launches {counts}",
              flush=True)

    # 3B: (1,2,1) at 720p and 1080p, then (1,1,2) at 720p
    cfg = PipelineConfig(resolution=720)
    n3 = cfg.dit.num_layers
    dit = random_dit(cfg.dit, torch.Generator(device=dev).manual_seed(42))
    lat720, lat1080 = latent((1, 2, 90, 160, 16), 1), latent((1, 3, 136, 240, 16), 2)
    single = Runner(cfg, dit, None, text, device=dev)
    ref720 = _phase8_step(single, lat720, 5)[0]
    ref1080 = _phase8_step(single, lat1080, 5)[0]
    seq_runner = Runner(cfg, dit, None, text, device=dev, mesh=meshes[(1, 2, 1)])
    run("seq_720p", seq_runner, lat720, ref720, {"K3s": n3, "K3": n3, "K3q": 0, "K3s_int8": 0, "K8": 0, "K9": 0})
    run("seq_1080p", seq_runner, lat1080, ref1080, {"K3s": n3, "K3": n3})
    # flash_attn_2: the unfused window path, K5 on the rank's windows (seq) or heads (tensor)
    dit.set_attention_mode("flash_attn_2")
    ref720f = _phase8_step(single, lat720, 5)[0]
    run("seq_720p_flash", seq_runner, lat720, ref720f, {"K5": n3, "K11": n3, "K3s": 0, "K3": 0})
    local = shard_dit(dit.set_attention_mode("fused"), meshes[(1, 1, 2)])
    del dit, single, seq_runner, ref1080, lat1080
    gc.collect()
    torch.cuda.empty_cache()
    tensor_runner = Runner(cfg, local, None, text, device=dev, mesh=meshes[(1, 1, 2)])
    run("tensor_720p", tensor_runner, lat720, ref720, {"K3s": n3, "K3": n3, "K3q": 0})
    local.set_attention_mode("flash_attn_2")
    run("tensor_720p_flash", tensor_runner, lat720, ref720f, {"K5": n3, "K11": n3, "K3s": 0, "K3": 0})
    del local, tensor_runner, ref720f
    gc.collect()
    torch.cuda.empty_cache()

    # 7B under sageattn_2 on (1,1,2): K3q in every layer of every rank
    cfg7 = pipeline_7b(resolution=720)
    n7 = cfg7.dit.num_layers
    dit7 = random_dit(cfg7.dit, torch.Generator(device=dev).manual_seed(43)).set_attention_mode("sageattn_2")
    ref7 = _phase8_step(Runner(cfg7, dit7, None, text, device=dev), lat720, 5)[0]
    local7 = shard_dit(dit7, meshes[(1, 1, 2)])
    del dit7
    gc.collect()
    torch.cuda.empty_cache()
    run("7b_tensor", Runner(cfg7, local7, None, text, device=dev, mesh=meshes[(1, 1, 2)]), lat720, ref7,
        {"K3s_int8": n7, "K3q": n7, "K3s": 0, "K3": 0})
    del local7, ref7
    gc.collect()
    torch.cuda.empty_cache()

    # generate_multichip, data=2: one 5-frame segment a rank, against rank 0's single-rank run
    g = torch.Generator(device=dev).manual_seed(44)
    dit, vae = random_dit(cfg.dit, g), random_vae(cfg.vae, g)
    if rank == 0:
        single_out = phases.generate(Runner(cfg, dit, vae, text, device=dev), frames)
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = generate_multichip(Runner(cfg, dit, vae, text, device=dev, mesh=meshes[(2, 1, 1)]), frames,
                             meshes[(2, 1, 1)], seam_overlap=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    # a rank's 5-frame segment: phase 5's batch (K8 = K9 = 52, every GroupNorm of the unfused VAE)
    expect(f"rank {rank} multichip", counts, {"K1": 48, "K2": 6, "K3": n3, "K3s": 0, "K8": 52, "K9": 52})
    entry = {"launches": counts, "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rank == 0:
        mean_err = float(np.abs(out - single_out).mean())
        rel = float(np.linalg.norm(out - single_out) / np.linalg.norm(single_out - 0.5))
        entry.update(mean_abs_diff=mean_err, rel_l2=rel, max_abs_diff=float(np.abs(out - single_out).max()))
        entry["shape"] = list(out.shape)
        if not (out.shape == single_out.shape and len(out) == len(frames) and np.isfinite(out).all()
                and mean_err <= 1e-2 and rel <= 5e-2):
            raise RuntimeError(f"multichip data=2 differs from one rank (mean {mean_err:.3e}, rel {rel:.3e})")
    elif out is not None:
        raise RuntimeError("multichip: a rank other than 0 returned frames")
    report["runs"]["multichip"] = entry
    print(f"  rank {rank} generate_multichip data=2: {wall:.2f} s, peak {entry['peak_gib']:.2f} GiB, "
          f"launches {counts}" + (f", vs one rank mean |diff| {entry['mean_abs_diff']:.3e} rel L2 "
                                  f"{entry['rel_l2']:.3e} max {entry['max_abs_diff']:.3e}" if rank == 0 else ""),
          flush=True)
    del out
    if rank == 0:
        del single_out

    # the tile-parallel VAE: 3 frames on data=2 are under 2 a rank, so both ranks run phases.generate on the
    # whole clip, each encoding and decoding its own tiles (i = rank mod 2) of a 512 px grid (6 tiles)
    tile, overlap = PHASE8_TILE
    cfg_t = cfg.replace(encode_tiled=True, decode_tiled=True, encode_tile_size=tile, decode_tile_size=tile,
                        encode_tile_overlap=overlap, decode_tile_overlap=overlap)
    few = frames[:3]
    entry = {}
    if rank == 0:
        reset_counts()
        single_out = phases.generate(Runner(cfg_t, dit, vae, text, device=dev), few)
        entry["single_launches"] = read_counts()
    dist.barrier()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = generate_multichip(Runner(cfg_t, dit, vae, text, device=dev, mesh=meshes[(2, 1, 1)]), few,
                             meshes[(2, 1, 1)])
    torch.cuda.synchronize()
    entry.update(launches=read_counts(), wall_s=time.perf_counter() - t0)
    # K8 = K9 on the unfused route: each of the rank's tile passes runs both for every GroupNorm
    expect(f"rank {rank} tiled fallback", entry["launches"], {"K3": n3, "K3s": 0, "K9": entry["launches"]["K8"]})
    if entry["launches"]["K1"] == 0:
        raise RuntimeError(f"rank {rank} tiled fallback: no VAE tile ran on this rank")
    if rank == 0:
        mean_err = float(np.abs(out - single_out).mean())
        rel = float(np.linalg.norm(out - single_out) / np.linalg.norm(single_out - 0.5))
        entry.update(mean_abs_diff=mean_err, rel_l2=rel, max_abs_diff=float(np.abs(out - single_out).max()),
                     shape=list(out.shape))
        if not (out.shape == single_out.shape and len(out) == len(few) and np.isfinite(out).all()
                and mean_err <= 1e-2 and rel <= 5e-2):
            raise RuntimeError(f"tile-parallel fallback differs from one rank (mean {mean_err:.3e}, rel {rel:.3e})")
    elif out is not None:
        raise RuntimeError("tiled fallback: a rank other than 0 returned frames")
    report["runs"]["tiled_fallback"] = entry
    print(f"  rank {rank} tile-parallel VAE (3 frames on data=2, tiles {tile[0]} px): {entry['wall_s']:.2f} s, "
          f"launches {entry['launches']}" + (f", vs one rank mean |diff| {entry['mean_abs_diff']:.3e} rel L2 "
                                             f"{entry['rel_l2']:.3e} max {entry['max_abs_diff']:.3e}, one rank's "
                                             f"launches {entry['single_launches']}" if rank == 0 else ""), flush=True)
    return report


def multi_rank_phase(dev, text):
    from seedvr2_tpu_torch.parallel.launch import launch

    print("  backend gloo: NCCL refuses two ranks on one device, so the ranks' tensors travel through host "
          "memory; every kernel runs on the card", flush=True)
    rows = _k3s_rows(dev, torch.Generator(device=dev).manual_seed(8))
    rows += _k5_rank_rows(dev, torch.Generator(device=dev).manual_seed(10))
    gc.collect()
    torch.cuda.empty_cache()  # the card's memory to the two ranks
    frames = np.random.RandomState(9).randint(0, 256, (10, 360, 640, 3)).astype(np.uint8)
    t0 = time.perf_counter()
    reports = launch(_phase8_rank, 2, (text, frames, str(dev)), backend="gloo", timeout=300.0, deadline=900.0)
    wall = time.perf_counter() - t0
    for row in rows:
        counts = reports[row.pop("rank")]["runs"][row["path"]]["launches"]
        row["launches"] = counts["K3s_int8" if row.pop("quant_qk") else row["kernel"]]
    tiled = [r["runs"]["tiled_fallback"] for r in reports]
    for kid in ("K1", "K2", "K8", "K9"):  # every tile ran on exactly one rank
        if sum(t["launches"][kid] for t in tiled) != tiled[0]["single_launches"][kid]:
            raise RuntimeError(f"tile-parallel VAE: {kid} launches {[t['launches'][kid] for t in tiled]} over the "
                               f"ranks, {tiled[0]['single_launches'][kid]} on one rank")
    return rows, {"wall_s": wall, "ranks": reports}


# --------------------------------------------------------------------------- #
# Phase 9: the CLI

# phase 9's inputs (height, width) and --resolution
PHASE9_HW = (360, 640)
PHASE9_RESOLUTION = 720


class _Interrupted(Exception):
    """Phase 9's stand-in for a run cut off after two chunks (the resume case)."""


def _mem_available_gib() -> float:
    with open("/proc/meminfo") as fh:
        return next(int(line.split()[1]) for line in fh if line.startswith("MemAvailable:")) / 2**20


class _Recording:
    """Wraps the CLI's video writer factory: every writer still writes its
    file, and the frames it was handed are kept for the comparison."""

    def __init__(self, make):
        self.make, self.frames = make, {}

    def __call__(self, path, *a, **kw):
        inner = self.make(path, *a, **kw)
        kept = self.frames.setdefault(path, [])
        write = inner.write

        def recorded(frames):
            kept.append(frames)
            write(frames)

        inner.write = recorded
        return inner


class _MemoryVideos:
    """Phase 9's video files on a machine with neither cv2 nor ffmpeg: the
    clips kept in memory by path behind make_video_reader's and
    make_video_writer's interface (each path also left as an empty file, for
    the resume manifest's checks). A written clip reads back as its 8-bit
    codes, as the cv2 mp4 sink keeps them."""

    def __init__(self):
        self.clips = {}

    def reader(self, path, dtype=np.float32, backend="auto", planar=False):
        from seedvr2_tpu_torch.io import video

        clip = self.clips[path] if dtype == np.uint8 else self.clips[path].astype(np.float32) / 255.0

        class Reader:
            fps, total_frames, dtype, planar, pos = 24.0, len(clip), clip.dtype, False, 0

            def seek(self, frame):
                self.pos = frame

            def read(self, n=None):
                out = clip[self.pos : len(clip) if n is None else self.pos + n]
                self.pos += len(out)
                return out

            def chunks(self, chunk_size, overlap=0):
                return video._chunks(self, chunk_size, overlap)

            def close(self):
                pass

        return Reader()

    def writer(self, path, width, height, fps, backend="auto", **kw):
        from seedvr2_tpu_torch.io.frameops import to_u8

        clips, parts = self.clips, []

        class Writer:
            def write(self, frames):
                parts.append(to_u8(np.asarray(frames)))

            def close(self):
                clips[path] = np.concatenate(parts)
                open(path, "wb").close()

        return Writer()


def _chunk_reference(runner, frames, chunk, ov):
    """The CLI's chunk loop by hand (the reference CLI's semantics): each
    chunk through phases.generate on the card, the first ``ov`` outputs of
    a chunk Hann-blended on the host with the tail held back before it."""
    from seedvr2_tpu_torch.ops.blending import overlap_weights
    from seedvr2_tpu_torch.pipeline import phases

    out, tail, start = [], None, 0
    while True:
        part_in = frames[start : start + chunk]
        if len(part_in) == 0 or (tail is not None and len(part_in) <= ov):
            break
        part = phases.generate(runner, part_in, packed=True)
        if tail is not None:
            k = min(ov, len(part), len(tail))
            w = overlap_weights(k).reshape(k, 1, 1, 1).astype(np.float32)
            blend = tail[-k:].astype(np.float32) * w + part[:k].astype(np.float32) * (1.0 - w)
            if part.dtype != np.float32:
                blend = blend + 0.5
            part = np.concatenate([blend.astype(part.dtype), part[k:]])
        if ov > 0 and len(part_in) == chunk:
            tail, part = part[-ov:], part[:-ov]
        else:
            tail = None
        out.append(part)
        if len(part_in) < chunk:
            break
        start += chunk - ov
    if tail is not None:
        out.append(tail)
    return np.concatenate(out)


def _fused_on_converted(runner, planes, out_h, out_w):
    """phases.generate's fused loop over planar frames with each batch's
    planes converted to RGB by ops/yuv.py on the card before
    Runner.fused_batch (which the planar route converts inside): packed
    codes."""
    from seedvr2_tpu_torch.ops.yuv import yuv420_to_rgb01
    from seedvr2_tpu_torch.pipeline import batching

    outs = []
    for spec in batching.compute_batches(len(planes), runner.cfg.batch_size):
        rgb = yuv420_to_rgb01(batching.prepare_batch(planes, spec).to_device(runner.device))
        outs.append(runner.fused_batch(rgb, out_h, out_w, runner.cfg.seed, ori=spec.ori_length).cpu().numpy())
    return np.concatenate(outs).astype(np.uint16)


def _same_codes(label, got, ref):
    """Output codes of a CLI run against phases.generate's: max |diff| 0."""
    from seedvr2_tpu_torch.io.frameops import to_u8

    a, b = to_u8(np.asarray(got)).astype(np.int64), to_u8(np.asarray(ref)).astype(np.int64)
    if a.shape != b.shape:
        raise RuntimeError(f"CLI {label}: output {a.shape}, phases.generate {b.shape}")
    diff = int(np.abs(a - b).max())
    if diff != 0:
        raise RuntimeError(f"CLI {label}: max |diff| {diff} codes from phases.generate on the same frames")
    return diff


def scratch_dir():
    """A temporary directory for phases 9, 10 and 13's checkpoints and
    their weights caches (6.6 GiB of safetensors and a 6.8 GiB bf16 cache,
    3.5 GiB of GGUF and two 3.6 GiB int8 caches in phase 10, another bf16
    cache in phase 13), in whichever of the system's temp directory and
    the repository's build/ has the most free space."""
    import tempfile
    from pathlib import Path

    roots = [tempfile.gettempdir(), str(Path(__file__).resolve().parent / "build")]
    Path(roots[1]).mkdir(exist_ok=True)
    root = max(roots, key=lambda r: shutil.disk_usage(r).free)
    free = shutil.disk_usage(root).free / 2**30
    if free < 32:
        raise RuntimeError(f"phases 9-13 write up to 25 GiB of weights and caches; {free:.1f} GiB free under {root}")
    return tempfile.TemporaryDirectory(dir=root)


def cli_phase(dev, per_batch, d):
    """Phase 9: seedvr2_tpu_torch/cli.py at full width (3B + VAE, bf16) on
    640x360 inputs to 720p, through safetensors that the port wrote into
    ``d`` (kept for phase 10), in this process so that the launch counters
    can be read. The first run
    reads the weights (cli.run); the later flag sets pass its runner back
    to cli.run, so the 6.6 GB are read once. Each run's output codes are
    held against phases.generate on the same decoded frames on the card
    (with the same host seam blend), max |diff| 0; K1, K2 and K3 against
    phase 5's per-batch counts (``per_batch``) times the batches."""
    from pathlib import Path

    from seedvr2_tpu_torch import cli
    from seedvr2_tpu_torch.config import dit_3b, vae_config
    from seedvr2_tpu_torch.io import video
    from seedvr2_tpu_torch.io.weights import save_random_checkpoint
    from seedvr2_tpu_torch.ops.resize import true_target_dims
    from seedvr2_tpu_torch.ops.yuv import (PlanarYUV420, is_planar, rgb01_to_yuv420_np, yuv420_to_rgb01,
                                           yuv420_to_rgb01_np)
    from seedvr2_tpu_torch.pipeline import phases

    h, w = PHASE9_HW
    out_h, out_w = true_target_dims(h, w, PHASE9_RESOLUTION)
    try:
        import cv2  # noqa: F401  (the PNG and mp4 I/O without ffmpeg)
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    have_ffmpeg = video.have_ffmpeg() and video.have_ffprobe()
    root = str(Path(d).parent)
    free = shutil.disk_usage(root).free / 2**30
    print(f"  video backends: cv2 {'yes' if have_cv2 else 'no'}, ffmpeg+ffprobe {'yes' if have_ffmpeg else 'no'}; "
          f"scratch {root}: {free:.1f} GiB free, host memory {_mem_available_gib():.1f} GiB available", flush=True)
    if not have_cv2:
        print("  no cv2: no PNG can be read or written here, so the image runs are left out", flush=True)
    memory = None if have_cv2 or have_ffmpeg else _MemoryVideos()
    if memory is not None:
        print("  neither cv2 nor ffmpeg: no video file can be read or written here, so the CLI's video runs read "
              "and write clips held in memory, behind the video module's reader and writer interface", flush=True)
    runs = {}
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(91)
    save_random_checkpoint(f"{d}/seedvr2_ema_3b_fp16.safetensors", "dit", dit_3b(), g)
    save_random_checkpoint(f"{d}/ema_vae_fp16.safetensors", "vae", vae_config(), g)
    torch.cuda.empty_cache()
    size = sum(p.stat().st_size for p in Path(d).glob("*.safetensors")) / 2**30
    write_s = time.perf_counter() - t0
    print(f"  checkpoints written: {size:.2f} GiB in {write_s:.1f} s", flush=True)
    rs = np.random.RandomState(23)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.float32) / 255.0
    if have_cv2:
        video.write_image(f"{d}/still.png", img)
        yy, xx = np.mgrid[0:h, 0:w]
        disc = ((yy - h // 2) ** 2 + (xx - w // 2) ** 2 < (h * 5 // 12) ** 2).astype(np.float32)[..., None]
        video.write_image(f"{d}/rgba.png", np.concatenate([img, disc], -1))
    files = (video.make_video_reader, video.make_video_writer)
    if memory is not None:
        video.make_video_reader, video.make_video_writer = memory.reader, memory.writer
    writer = video.make_video_writer(f"{d}/clip.mp4", w, h, 24.0)
    writer.write(rs.randint(0, 256, (12, h, w, 3)).astype(np.float32) / 255.0)
    writer.close()
    reader = video.make_video_reader(f"{d}/clip.mp4", np.uint8)
    decoded = reader.read()  # the frames the CLI will see
    reader.close()
    base = ["--model_dir", d, "--resolution", str(PHASE9_RESOLUTION), "--cuda_device", str(dev.index or 0)]
    recording = _Recording(video.make_video_writer)
    video.make_video_writer = recording
    runner = None

    def drive(label, argv, batches=None, processed=None):
        """One CLI run; ``batches``: its 5-frame batches, whose K1, K2
        and K3 counts it must launch (else the caller holds the counts
        against its reference run's); ``processed``: the frames it
        upscales, where it writes more (a resumed run counts the chunks
        done before)."""
        nonlocal runner
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        cold = runner is None  # the first run loads the weights: converted, and the cache written
        t = time.perf_counter()
        n, runner = cli.run(argv + base, runner)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if batches is not None:
            expect(f"CLI {label}", counts, {k: per_batch[k] * batches for k in PER_BATCH})
        n = n if processed is None else processed
        runs[label] = {"frames": n, "wall_s": wall, "fps": n / wall, "peak_gib": peak,
                       "launches": {k: counts[k] for k in ("K1", "K2", "K3", "K3q", "K4", "K5", "K8", "K9")}}
        if cold:
            cache = sum(f.stat().st_size for f in Path(d, "torch_cache").iterdir()) / 2**30
            runs[label]["cache_gib"] = cache
            print(f"  CLI {label}: the cold load converted both files and wrote {cache:.2f} GiB of weights cache",
                  flush=True)
        print(f"  CLI {label}: {n} frames upscaled in {wall:.2f} s ({n / wall:.2f} fps), peak {peak:.2f} GiB, "
              f"launches {runs[label]['launches']}", flush=True)
        return cli.build_config(cli.parse_arguments(argv + base))

    def image_reference(label, cfg, path):
        """phases.generate on the image at ``path`` (its launches counted
        alone): the CLI run ``label`` must have launched as many K1, K2,
        K3, K8 and K9 (an image is one batch: phase 5's K1, K3, K8 and K9 a
        batch; K2 3, one latent frame)."""
        reset_counts()
        ref = phases.generate(runner.with_config(cfg), video.read_image(path)[None], packed=True)
        counts = read_counts()
        want = {k: counts[k] for k in PER_BATCH}
        if any(want[k] != per_batch[k] for k in ("K1", "K3", "K8", "K9")) or want["K2"] == 0:
            raise RuntimeError(f"{label}: phases.generate on the image launched {want}")
        expect(f"CLI {label}", runs[label]["launches"], want)
        return ref

    if have_cv2:
        # an image: the run that reads the weights (its wall includes the cold load: the conversion and the
        # cache write)
        cfg = drive("image (weights read)", [f"{d}/still.png", "--output", f"{d}/still_up.png", "--debug"])
        ref = image_reference("image (weights read)", cfg, f"{d}/still.png")
        runs["image (weights read)"]["max_abs_diff_codes"] = _same_codes(
            "image", video.read_image(f"{d}/still_up.png"), ref[0])
        # an RGBA image: the alpha route (4 phases, alpha upscaled against the RGB)
        cfg = drive("rgba image", [f"{d}/rgba.png", "--output", f"{d}/rgba_up.png"])
        out = video.read_image(f"{d}/rgba_up.png")
        ref = image_reference("rgba image", cfg, f"{d}/rgba.png")
        if out.shape != (out_h, out_w, 4):
            raise RuntimeError(f"CLI rgba: output {out.shape}")
        runs["rgba image"]["max_abs_diff_codes"] = _same_codes("rgba", out, ref[0])
    # 12 frames in chunks of 5 overlapping by 3: frames 0-4, 2-6, 4-8, 6-10 and 8-11, one batch each (the
    # 4-phase path: the overlap applies inside a chunk too), 4 seams of 3 frames weighed 1, 0.5 and 0
    argv = [f"{d}/clip.mp4", "--output", f"{d}/chunks.mp4", "--chunk_size", "5", "--temporal_overlap", "3"]
    cfg = drive("video chunks 5 overlap 3", argv, batches=5)
    got = np.concatenate(recording.frames[f"{d}/chunks.mp4"])
    ref = _chunk_reference(runner.with_config(cfg), decoded, 5, 3)
    runs["video chunks 5 overlap 3"]["max_abs_diff_codes"] = _same_codes("chunks", got, ref)
    # --resume: a chunked run cut off in its third chunk, then resumed: only the third chunk runs
    argv = [f"{d}/clip.mp4", "--output", f"{d}/resume.mp4", "--chunk_size", "5"]
    real, calls = cli.process_frames, []

    def cut_at_third(*a, **kw):
        calls.append(len(a[2]))
        if len(calls) == 3:
            raise _Interrupted
        return real(*a, **kw)

    cli.process_frames = cut_at_third
    try:
        cli.run(argv + base, runner)
    except _Interrupted:
        pass
    finally:
        cli.process_frames = real
    manifest = json.load(open(f"{d}/resume.mp4.resume.json"))
    if manifest["chunks_done"] != 2:
        raise RuntimeError(f"CLI resume: the manifest of the cut run says {manifest['chunks_done']} chunks done")
    cfg = drive("video resume (third chunk)", argv + ["--resume"], batches=1, processed=2)
    got = np.concatenate(recording.frames[f"{d}/resume.part0002.mp4"][-1:])
    ref = phases.generate(runner.with_config(cfg), decoded[10:], packed=True)
    runs["video resume (third chunk)"]["max_abs_diff_codes"] = _same_codes("resume", got, ref)
    parts = sorted(Path(d).glob("resume.part*.mp4"))
    finals = parts if parts else [Path(f"{d}/resume.mp4")]
    total = sum(video.make_video_reader(str(p)).total_frames for p in finals)
    if total != 12:
        raise RuntimeError(f"CLI resume: {total} frames written in {[p.name for p in finals]}")
    # the noise flags: the 12 frames in 5-frame batches (5, 5, 2 + 3 padding)
    argv = [f"{d}/clip.mp4", "--output", f"{d}/noise.mp4", "--input_noise_scale", "0.1",
            "--latent_noise_scale", "0.1"]
    cfg = drive("video noise 0.1 / 0.1", argv, batches=3)
    got = np.concatenate(recording.frames[f"{d}/noise.mp4"])
    ref = phases.generate(runner.with_config(cfg), decoded, packed=True)
    runs["video noise 0.1 / 0.1"]["max_abs_diff_codes"] = _same_codes("noise", got, ref)
    plain = phases.generate(runner.with_config(cfg.replace(input_noise_scale=0.0, latent_noise_scale=0.0)),
                            decoded, packed=True)
    if np.array_equal(plain, ref):
        raise RuntimeError("CLI noise: the noise flags left the output unchanged")
    # yuv420: the CLI's --pixfmt yuv420 where ffmpeg can sink planes, else the pipeline API on the card
    rgb_cfg = cfg.replace(input_noise_scale=0.0, latent_noise_scale=0.0, output_pixfmt="rgb", output_bits=16)
    rgb = phases.generate(runner.with_config(rgb_cfg), decoded)
    if have_ffmpeg:
        drive("video --pixfmt yuv420", [f"{d}/clip.mp4", "--output", f"{d}/yuv.mp4", "--pixfmt", "yuv420"],
              batches=3)
        parts = recording.frames[f"{d}/yuv.mp4"]
        planes = PlanarYUV420(*(np.concatenate([getattr(p, a) for p in parts]) for a in "yuv"), depth=parts[0].depth)
    else:
        print("  yuv420: no ffmpeg on this machine, so no planar mp4 sink: the fused path's planes are "
              "packed on the card through phases.generate (output_pixfmt yuv420), and planar input "
              "(the decoded frames' BT.601 planes) is converted there", flush=True)
        reset_counts()
        planes = phases.generate(runner.with_config(rgb_cfg.replace(output_pixfmt="yuv420")), decoded,
                                 packed=True)
        expect("yuv420 planes", read_counts(), {k: per_batch[k] * 3 for k in PER_BATCH})
    if not (is_planar(planes) and planes.depth == 10 and planes.shape == (12, out_h, out_w, 3)):
        raise RuntimeError(f"yuv420: got {type(planes).__name__} {getattr(planes, 'shape', None)}")
    want = rgb01_to_yuv420_np(rgb, 10)
    plane_diff = max(int(np.abs(getattr(planes, a).astype(np.int64) - getattr(want, a).astype(np.int64)).max())
                     for a in "yuv")
    if plane_diff > 1:
        raise RuntimeError(f"yuv420: planes {plane_diff} codes from rgb01_to_yuv420_np of the RGB result")
    # planar input: the decoded frames' 4:2:0 planes, uploaded as planes and converted inside
    # Runner.fused_batch; held against the same loop with each batch's planes converted by ops/yuv.py
    # before fused_batch (max |diff| 0 codes), and that conversion on the card against the host's
    # yuv420_to_rgb01_np (fp32: max |diff| <= 1e-6). phases.generate on host-converted frames is no exact
    # reference: float frames go to the card as float16.
    planar_in = rgb01_to_yuv420_np(decoded.astype(np.float32) / 255.0, 8)
    rgb_runner = runner.with_config(rgb_cfg)
    from_planes = phases.generate(rgb_runner, planar_in, packed=True)
    converted = _fused_on_converted(rgb_runner, planar_in, out_h, out_w)
    if not (from_planes.shape == converted.shape == rgb.shape and from_planes.dtype == np.uint16):
        raise RuntimeError(f"planar input: shapes {from_planes.shape} {converted.shape}")
    exact = int(np.abs(from_planes.astype(np.int64) - converted.astype(np.int64)).max())
    on_card = yuv420_to_rgb01(planar_in.to_device(dev)).cpu().numpy().astype(np.float64)
    conversion = float(np.abs(on_card - yuv420_to_rgb01_np(planar_in)).max())
    if exact != 0 or conversion > 1e-6:
        raise RuntimeError(f"planar input: max |diff| {exact} codes from the planes converted on the card; "
                           f"the card's conversion {conversion:.3e} from the host's")
    runs["yuv420"] = {"max_plane_diff_codes": plane_diff, "ffmpeg_sink": have_ffmpeg,
                      "planar_input_max_abs_diff_vs_card_converted_codes": exact,
                      "card_vs_host_conversion_max_abs_diff": conversion,
                      "planar_input_mean_abs_diff_vs_rgb_input": float(
                          np.abs(from_planes.astype(np.float64) / 65535.0 - rgb).mean())}
    print(f"  yuv420 planes vs rgb01_to_yuv420_np of the RGB result: max |diff| {plane_diff} code; planar "
          f"input vs the planes converted on the card: max |diff| {exact} codes, the card's conversion vs "
          f"the host's {conversion:.3e}; vs the RGB input: mean "
          f"{runs['yuv420']['planar_input_mean_abs_diff_vs_rgb_input']:.3e} (chroma subsampling)", flush=True)
    # cfg_scale 2 through the same runner (a Python API setting): the DiT runs on both prompts
    cfg2 = rgb_cfg.replace(diffusion=dataclasses.replace(rgb_cfg.diffusion, cfg_scale=2.0))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    out2 = phases.generate(runner.with_config(cfg2), decoded[:5])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    expect("cfg_scale 2", counts, {**{k: per_batch[k] for k in PER_BATCH}, "K3": 2 * per_batch["K3"]})
    if not (out2.shape == (5, out_h, out_w, 3) and np.isfinite(out2).all()
            and np.abs(out2 - rgb[:5]).max() > 1e-3):
        raise RuntimeError("cfg_scale 2: bad output, or the same as cfg_scale 1")
    runs["cfg_scale 2 (5 frames, phases.generate)"] = {
        "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": {k: counts[k] for k in PER_BATCH}}
    print(f"  cfg_scale 2: 5 frames in {wall:.2f} s, K3 {counts['K3']} (two DiT passes)", flush=True)
    # the guided step against two unguided ones: one Euler step is affine in the DiT's prediction, so with
    # cfg_rescale 0 it is neg + 2 (pos - neg) of two cfg_scale 1 steps, the second with the negative prompt
    # as its positive (bf16 steps: rel L2 <= 1e-2, as phase 8's steps)
    vc = rgb_cfg.vae
    g2 = torch.Generator(device=dev).manual_seed(92)
    lat = torch.randn((1, 2, out_h // vc.spatial_downsample_factor, out_w // vc.spatial_downsample_factor,
                       vc.latent_channels), generator=g2, device=dev)
    negative = runner.with_config(rgb_cfg)
    negative.text_pos = runner.text_neg
    steps = {key: r.upscale(lat, rgb_cfg.seed).float() for key, r in (
        ("guided", runner.with_config(cfg2)), ("pos", runner.with_config(rgb_cfg)), ("neg", negative))}
    combined = steps["neg"] + 2.0 * (steps["pos"] - steps["neg"])
    step_rel = _rel((steps["guided"],), (combined,))
    apart = _rel((steps["pos"],), (combined,))
    if not step_rel <= 1e-2:
        raise RuntimeError(f"cfg_scale 2: the guided step is {step_rel:.3e} rel L2 from neg + 2 (pos - neg)")
    runs["cfg_scale 2 (5 frames, phases.generate)"].update(step_rel_l2_vs_combined=step_rel,
                                                          unguided_rel_l2_vs_combined=apart)
    print(f"  cfg_scale 2 step vs neg + 2 (pos - neg) of two unguided steps: rel L2 {step_rel:.3e} (the "
          f"positive step alone: {apart:.3e})", flush=True)
    video.make_video_reader, video.make_video_writer = files
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return {"checkpoint_gib": size, "checkpoint_write_s": write_s, "video_backends": {
        "cv2": have_cv2, "ffmpeg": have_ffmpeg, "in_memory": memory is not None}, "runs": runs}


# --------------------------------------------------------------------------- #
# Phase 10: int8 weights
# --------------------------------------------------------------------------- #


def _dequantized_dit(dit):
    """A bf16 NaDiT whose weights are ``dit``'s int8 leaves dequantized (w_q *
    w_s in fp32, rounded to bf16), built on the same card."""
    from seedvr2_tpu_torch.io.weights import dit_from_flat
    from seedvr2_tpu_torch.models.params import leaf_paths
    from seedvr2_tpu_torch.ops.quant import dequantize_weight

    flat = {}
    for path, m, leaf in leaf_paths(dit):
        if leaf == "w_q":
            flat[path[: -len("w_q")] + "w"] = dequantize_weight({"w_q": m.jax_value("w_q"), "w_s": m.w_s})
        elif leaf != "w_s":
            flat[path] = m.jax_value(leaf)
    with torch.inference_mode():
        return dit_from_flat(flat, dit.cfg, dit.vid_in.w.device, torch.bfloat16)


def expect_k7_shapes(label, launches, cfg):
    """A 720p batch of an int8 DiT runs K7 at each of its linears' shapes,
    at the video rows (M = 2 x 45 x 80 = 7200 tokens) and the text rows (M
    = 58): read_counts' "K7_shapes"."""
    from seedvr2_tpu_torch.conv_ab import int8_linear_shapes

    missing = [k7_shape(M, K, N) for M in (7200, 58) for _, K, N, _ in int8_linear_shapes(cfg)
               if not launches["K7_shapes"].get(k7_shape(M, K, N))]
    if missing:
        raise RuntimeError(f"{label}: no K7 launch at {missing}")


def int8_phase(dev, text, frames, d, per_batch):
    """Phase 10: int8 weights at full width. (a) NaDiT-7B with
    quantize="int8" under sageattn_2 (weights drawn and quantized on the
    card) and the VAE through phases.generate, two runs: K7 launches =
    int8_linear_calls, K3q 36; its DiT step against a bf16 7B with the same
    int8 leaves dequantized (rel L2 <= 5e-2), and, for information, against
    the unquantized bf16 step on the same draws. (b) NaDiT-3B through the
    CLI's argv in this process: --quantize int8 from phase 9's safetensors,
    then a .gguf (Q8_0 block linears, F16 other matrices, F32 vectors)
    that io/gguf.py writes from the same weights; each output against
    phases.generate on the runner the CLI loaded (max |diff| 0 codes), its
    launches against the per-batch counts of phase 5 and K7's."""
    from seedvr2_tpu_torch import cli
    from seedvr2_tpu_torch.config import pipeline_7b
    from seedvr2_tpu_torch.io import gguf, video
    from seedvr2_tpu_torch.io.checkpoint import load_safetensors
    from seedvr2_tpu_torch.io.weights import random_dit, random_vae
    from seedvr2_tpu_torch.ops.quant import quantize_linear, tree_bytes
    from seedvr2_tpu_torch.pipeline import phases
    from seedvr2_tpu_torch.pipeline.runner import Runner

    INT8_RUNS["allowed"] = True
    out = {}
    # (a) 7B int8 under sageattn_2
    cfg = pipeline_7b(resolution=720)
    t0 = time.perf_counter()
    dit = random_dit(cfg.dit, torch.Generator(device=dev).manual_seed(101), quantize="int8")
    dit.set_attention_mode("sageattn_2")
    vae = random_vae(cfg.vae, torch.Generator(device=dev).manual_seed(102))
    runner = Runner(cfg, dit, vae, text, device=dev)
    torch.cuda.synchronize()
    dit_gib = tree_bytes(dit) / 2**30
    print(f"  7B int8 weights drawn and quantized on the card in {time.perf_counter() - t0:.1f} s: DiT {dit_gib:.2f} "
          f"GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    launches, e2e = drive(runner, frames, "7B int8 sageattn_2")
    per_step = int8_linear_calls(dit)
    expect("7B int8 sageattn_2", launches, {"K7": per_step, "K3q": cfg.dit.num_layers, "K3": 0, "K5": 0,
                                            "K8": per_batch["K8"], "K9": per_batch["K9"]})
    if not (launches["K7_wgmma"] > 0 and launches["K7_splitk"] > 0
            and launches["K7_wgmma"] + launches["K7_splitk"] == per_step):
        raise RuntimeError(f"7B int8: K7's regimes {launches['K7_wgmma']} wgmma + {launches['K7_splitk']} split-K")
    expect_k7_shapes("7B int8 sageattn_2", launches, cfg.dit)
    vc = cfg.vae
    lat = torch.randn((1, 2, 720 // vc.spatial_downsample_factor, 1280 // vc.spatial_downsample_factor,
                       vc.latent_channels), generator=torch.Generator(device=dev).manual_seed(103), device=dev)
    step = _phase8_step(runner, lat, cfg.seed)[0]
    deq = Runner(cfg, _dequantized_dit(dit).set_attention_mode("sageattn_2"), vae, text, device=dev)
    step_deq = _phase8_step(deq, lat, cfg.seed)[0]
    del deq
    torch.cuda.empty_cache()
    rel_deq = _rel((step,), (step_deq,))
    if not (torch.isfinite(step).all() and rel_deq <= 5e-2):
        raise RuntimeError(f"7B int8 step is {rel_deq:.3e} rel L2 from the bf16 step on its dequantized weights")
    del runner, dit
    gc.collect()
    torch.cuda.empty_cache()
    dense = Runner(cfg, random_dit(cfg.dit, torch.Generator(device=dev).manual_seed(101)).set_attention_mode(
        "sageattn_2"), vae, text, device=dev)
    rel_dense = _rel((step,), (_phase8_step(dense, lat, cfg.seed)[0],))
    del dense, vae
    gc.collect()
    torch.cuda.empty_cache()
    e2e.update(dit_gib=dit_gib, k7_per_step=per_step, step_rel_l2_vs_dequantized_bf16=rel_deq,
               step_rel_l2_vs_unquantized_bf16=rel_dense)
    out["7b_int8_sageattn_2"] = e2e
    print(f"  7B int8 step vs the bf16 step on its dequantized weights: rel L2 {rel_deq:.3e}; vs the unquantized "
          f"bf16 step on the same draws (the quantization error): {rel_dense:.3e}", flush=True)

    # (b) 3B through the CLI: int8 from safetensors, then GGUF
    have_io = video.have_ffmpeg() and video.have_ffprobe()
    try:
        import cv2  # noqa: F401
        have_io = True
    except ImportError:
        pass
    files = (video.make_video_reader, video.make_video_writer)
    if not have_io:
        memory = _MemoryVideos()
        video.make_video_reader, video.make_video_writer = memory.reader, memory.writer
    try:
        h, w = PHASE9_HW
        writer = video.make_video_writer(f"{d}/int8_in.mp4", w, h, 24.0)
        writer.write(frames.astype(np.float32) / 255.0)
        writer.close()
        reader = video.make_video_reader(f"{d}/int8_in.mp4", np.uint8)
        decoded = reader.read()
        reader.close()
        recording = _Recording(video.make_video_writer)
        video.make_video_writer = recording
        base = ["--model_dir", d, "--resolution", str(PHASE9_RESOLUTION), "--cuda_device", str(dev.index or 0)]
        safetensors = f"{d}/seedvr2_ema_3b_fp16.safetensors"
        t0 = time.perf_counter()
        state = load_safetensors(safetensors)
        types = {k: (v, gguf.Q8_0 if k.startswith("blocks.") and v.ndim == 2 else gguf.F16 if v.ndim >= 2
                     else gguf.F32) for k, v in state.items()}
        gguf.write_gguf(f"{d}/seedvr2_ema_3b-Q8_0.gguf", types)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        read = gguf.load_gguf_state_dict(f"{d}/seedvr2_ema_3b-Q8_0.gguf")
        read_s = time.perf_counter() - t0
        qkv_key = "blocks.0.attn.proj_qkv.vid.weight"
        qkv_t = {"safetensors": state[qkv_key], "gguf": read[qkv_key]}
        del state, read, types
        gc.collect()
        gib = os.path.getsize(f"{d}/seedvr2_ema_3b-Q8_0.gguf") / 2**30
        print(f"  GGUF written from phase 9's 3B safetensors: {gib:.2f} GiB in {write_s:.1f} s; read and dequantized "
              f"(numpy, host) in {read_s:.1f} s", flush=True)
        out["3b_gguf_file"] = {"gib": gib, "write_s": write_s, "read_dequantize_s": read_s}
        for label, argv, source in (
            ("3B --quantize int8 (safetensors)", ["--quantize", "int8"], "safetensors"),
            ("3B .gguf", ["--dit_model", "seedvr2_ema_3b-Q8_0.gguf"], "gguf"),
        ):
            # the load path's cold and warm start for this int8 DiT (phase 13 (c)'s checks): its cache removed,
            # load_runner converts and writes it, a second load reads it back; every tensor of the two equal
            dit_file = "seedvr2_ema_3b-Q8_0.gguf" if source == "gguf" else "seedvr2_ema_3b_fp16.safetensors"
            quantize = "int8" if source == "safetensors" else None
            for f in Path(d, "torch_cache").glob(f"{dit_file}.*int8*"):
                f.unlink()
            cold, cold_s = _timed_load(dev, d, dit_file, "converted", quantize)
            warm, warm_s = _timed_load(dev, d, dit_file, "read", quantize)
            n_equal = _same_tensors(f"{label} cold vs warm", cold, warm)
            del cold, warm
            out[f"{label} load"] = {"cold_s": cold_s, "warm_s": warm_s, "tensors_equal": n_equal}
            print(f"  {label}: cold load (converted, cache written) {cold_s:.2f} s, warm load (cache read) "
                  f"{warm_s:.2f} s, {n_equal} DiT and VAE tensors equal", flush=True)
            out_path = f"{d}/int8_{source}.mp4"
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            n, runner = cli.run([f"{d}/int8_in.mp4", "--output", out_path, *argv, *base], None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = int8_linear_calls(runner.dit)
            expect(f"CLI {label}", counts, {"K7": want, **{k: per_batch[k] for k in PER_BATCH}})
            expect_k7_shapes(f"CLI {label}", counts, runner.dit.cfg)
            # the loaded int8 leaves: the file's weight converted and quantized whole (bit-equal)
            qkv = quantize_linear(np.ascontiguousarray(qkv_t[source].T).reshape(qkv_t[source].shape[1], 3, -1))
            leaf = runner.dit.blocks[0].attn.qkv["vid"]
            if not (torch.equal(leaf.jax_value("w_q").cpu(), qkv["w_q"]) and torch.equal(leaf.w_s.cpu(), qkv["w_s"])):
                raise RuntimeError(f"CLI {label}: the loaded int8 qkv of block 0 is not the file's weight quantized")
            cfg3 = cli.build_config(cli.parse_arguments([f"{d}/int8_in.mp4", *argv, *base]))
            ref = phases.generate(runner.with_config(cfg3), decoded, packed=True)
            got = np.concatenate(recording.frames[out_path])
            diff = _same_codes(label, got, ref)
            dit_gib = tree_bytes(runner.dit) / 2**30
            out[label] = {"frames": n, "wall_s": wall, "peak_gib": peak, "dit_gib": dit_gib,
                          "launches": {k: counts[k] for k in ("K7", "K7_wgmma", "K7_splitk", "K7_shapes",
                                                              *PER_BATCH)}, "max_abs_diff_codes": diff}
            print(f"  CLI {label}: {n} frames in {wall:.2f} s (the warm load from the cache included), "
                  f"DiT {dit_gib:.2f} GiB, peak {peak:.2f} GiB, launches {out[label]['launches']}, max |diff| vs "
                  f"phases.generate {diff} codes", flush=True)
            del runner
            gc.collect()
            torch.cuda.empty_cache()
        for f in [Path(d, "seedvr2_ema_3b-Q8_0.gguf"), *Path(d, "torch_cache").glob("*int8*")]:
            f.unlink()  # room on disk for phase 13's cache
    finally:
        video.make_video_reader, video.make_video_writer = files
        INT8_RUNS["allowed"] = False
    return out, launches


def _timed_load(dev, d, dit_file, want, quantize=None):
    """load_runner on the card from ``d`` (3B, the VAE of phase 9, at
    phase 9's resolution), timed to its last copy; ``want``: "converted"
    or "read", what the weights cache must have done for this DiT file
    (its forced log line)."""
    from seedvr2_tpu_torch.pipeline.loader import load_runner, pick_config

    log = _recorded_log()
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = load_runner(dit_file, "ema_vae_fp16.safetensors", str(d),
                         pick_config(dit_file).replace(resolution=PHASE9_RESOLUTION), device=dev, quantize=quantize,
                         debug=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not any(f"Weights cache: {want}" in ln and dit_file in ln for ln in log.lines):
        raise RuntimeError(f"load of {dit_file}: the weights cache did not report '{want}': {log.lines}")
    return runner, wall


def _same_tensors(label, a, b) -> int:
    """Every DiT and VAE tensor of runners ``a`` and ``b`` (buffers, K1's
    stored layout and K2's folds: models/params.py:loaded_tensors) of the
    same type and bit-equal; their count."""
    from seedvr2_tpu_torch.models.params import loaded_tensors

    n = 0
    for part in ("dit", "vae"):
        ta, tb = loaded_tensors(getattr(a, part)), loaded_tensors(getattr(b, part))
        if ta.keys() != tb.keys():
            raise RuntimeError(f"{label}: the {part}s hold different tensors")
        bad = [k for k in ta if ta[k].dtype != tb[k].dtype or not torch.equal(ta[k], tb[k])]
        if bad:
            raise RuntimeError(f"{label}: {len(bad)} {part} tensors differ, e.g. {bad[:3]}")
        n += len(ta)
    return n


# --------------------------------------------------------------------------- #
# Phase 13: the load path's cold start
# --------------------------------------------------------------------------- #


def load_phase(dev, frames, d, per_batch):
    """Phase 13: load_runner through the weights cache (io/native_ckpt.py)
    on phase 9's 3B fp16 safetensors and VAE, linked into a fresh
    directory so that the first load is cold. (a) A cold load in a child
    process that imports only seedvr2_tpu_torch (load_probe.run_child):
    the streamed conversion and the cache write; its wall, ru_maxrss, peak
    RssAnon and the cache's bytes. (b) A warm one, the same numbers. (d)
    os.utime on the source: (c)'s first load in this process is cold
    again (the cache stale), its second warm: every DiT and VAE tensor
    equal, one phases.generate batch of the main path's clip from each, 0
    codes apart, K1, K2 and K3 = phase 5's counts a batch."""
    from seedvr2_tpu_torch import load_probe
    from seedvr2_tpu_torch.pipeline import phases

    dit_file, out = "seedvr2_ema_3b_fp16.safetensors", {}
    fresh = Path(d) / "phase13"
    fresh.mkdir()
    for name in (dit_file, "ema_vae_fp16.safetensors"):
        (fresh / name).symlink_to(Path(d) / name)
    for load, want in (("cold", "converted"), ("warm", "read")):
        rec = load_probe.run_child(Path(load_probe.ROOT), fresh, dit_file, None)
        rec["cache_gib"] = load_probe.cache_bytes(fresh) / 2**30
        if not any(f"Weights cache: {want}" in ln and dit_file in ln for ln in rec["cache_log"]):
            raise RuntimeError(f"(a)/(b) {load} load in a child: the cache did not report '{want}': {rec['cache_log']}")
        out[load] = rec
        print(f"  ({'a' if load == 'cold' else 'b'}) {load} load in a child process: {rec['wall_s']:.2f} s, ru_maxrss "
              f"{rec['ru_maxrss_gib']:.2f} GiB ({rec['ru_maxrss_before_gib']:.2f} before the load), RssAnon peak "
              f"{rec['rss_anon_peak_gib']:.2f} GiB ({rec['rss_anon_before_gib']:.2f} before), cache "
              f"{rec['cache_gib']:.2f} GiB on disk", flush=True)
    st = os.stat(fresh / dit_file)
    os.utime(fresh / dit_file, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))  # (d): the source touched
    cold, cold_s = _timed_load(dev, fresh, dit_file, "converted")
    warm, warm_s = _timed_load(dev, fresh, dit_file, "read")
    n_equal = _same_tensors("phase 13 cold vs warm", cold, warm)
    outs = []
    for runner in (cold, warm):
        reset_counts()
        outs.append(phases.generate(runner, frames))
        expect("phase 13 batch", read_counts(), {k: per_batch[k] for k in PER_BATCH})
    diff = _max_code_diff(*outs)
    if diff != 0 or len(outs[0]) != len(frames) or not np.isfinite(outs[0]).all():
        raise RuntimeError(f"phase 13: the cold and warm runners' batches are {diff} codes apart ({outs[0].shape})")
    out["in_process"] = {"cold_after_utime_s": cold_s, "warm_s": warm_s, "tensors_equal": n_equal,
                         "max_abs_diff_codes": diff}
    print(f"  (d) source touched: the next load converts again; (c) in this process: cold {cold_s:.2f} s, warm "
          f"{warm_s:.2f} s, {n_equal} DiT and VAE tensors equal, one batch from each {diff} codes apart, "
          f"{' / '.join(PER_BATCH)} = phase 5's a batch", flush=True)
    del cold, warm
    shutil.rmtree(fresh)
    return out


# --------------------------------------------------------------------------- #
# Phase 11: the ComfyUI node layer
# --------------------------------------------------------------------------- #

# (c) the interrupt's clip: 10 frames in two 5-frame batches; (d) and (e) the
# ladder's batch: phase 7's geometry (960x540 -> 1920x1080), one 5-frame batch
PHASE11_INTERRUPT_FRAMES = 10
PHASE11_LADDER_HW = (540, 960)
PHASE11_LADDER_RESOLUTION = 1080
# (d) the card's share that the ladder runs under, from the peaks that (d)
# measures first (on the H100 80GB, of 79.18 GiB, the weights included; every
# GroupNorm on K8 + K9): the fused route 26.15 GiB, the encode untiled /
# 1024 px / 512 px tiles 19.40 / 10.74 / 8.20, the DiT step 8.29, the decode
# untiled / 1024 / 512 26.02 / 12.87 / 8.85. 0.15 (11.88 GiB) is above the
# 1024 px encode and the 512 px decode, below the 1024 px decode: the ladder
# must take the fused fallback, one encode rung and two decode rungs.
PHASE11_MEMORY_FRACTION = 0.15
PHASE11_RUNGS = [(False, (1024, 1024)), (True, (1024, 1024)), (True, (512, 512)), (True, (256, 256))]
# (e) the staged decode's tiles, against the device-tiled decode at the same tiles
PHASE11_STAGED_TILE = ((512, 512), (64, 64))


def _comfy_stub():
    """tests/comfy_stub.py of this checkout (it imports neither jax nor the
    JAX package): the ComfyUI host modules the node layer touches."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("comfy_stub", Path(__file__).resolve().parent / "tests" /
                                                  "comfy_stub.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def _recorded_log():
    """A Debug whose printed lines (every forced one: the ladder's rungs)
    are also kept in ``lines``."""
    from seedvr2_tpu_torch.utils.debug import Debug

    class Log(Debug):
        def __init__(self):
            super().__init__()
            self.lines = []

        def log(self, msg, category="info", force=False, indent_level=0):
            if self.enabled or force:
                self.lines.append(msg)
            super().log(msg, category, force, indent_level)

    return Log()


def _record_vae_attempts(runner, attempts):
    """Wrap a runner's raw VAE stages (both routes call them): each attempt's
    (stage, tiled, tile size, overlap, "ok" or "oom") lands in ``attempts``."""
    for stage in ("_encode", "_decode"):
        raw = getattr(runner, stage)

        def rec(x, tiled, ts, to, tile_parallel=True, _raw=raw, _name=stage[1:]):
            try:
                out = _raw(x, tiled, ts, to, tile_parallel)
            except torch.cuda.OutOfMemoryError:
                attempts.append((_name, tiled, tuple(ts), tuple(to), "oom"))
                raise
            attempts.append((_name, tiled, tuple(ts), tuple(to), "ok"))
            return out

        setattr(runner, stage, rec)


def _max_code_diff(a, b) -> int:
    """Largest difference of two [0, 1] float clips in 16-bit codes."""
    if a.shape != b.shape:
        raise RuntimeError(f"shapes differ: {a.shape} vs {b.shape}")
    return int(np.abs(np.rint(np.asarray(a, np.float64) * 65535) - np.rint(np.asarray(b, np.float64) * 65535)).max())


def _peak_call(dev, fn):
    """(result, seconds, peak GiB) of fn() from a clean peak counter."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) / 2**30


def node_phase(dev, per_batch, d, frames):
    """Phase 11: the node layer (seedvr2_tpu_torch/interfaces.py) under the
    stub ComfyUI host, at full width (3B + VAE, bf16) from phase 9's
    safetensors in ``d``: (a) the V3 workflow on the main path's clip, (b)
    a cached second execute, (c) the interrupt, (d) the OOM ladder under a
    memory cap at 1080p, (e) the host-staged decode against the
    device-tiled one. Every check raises."""
    import asyncio

    import pytest

    from seedvr2_tpu_torch import interfaces as I
    from seedvr2_tpu_torch.models.vae import tiling
    from seedvr2_tpu_torch.ops.resize import pipeline_transform, to_f01, true_target_dims
    from seedvr2_tpu_torch.pipeline import loader, phases
    from seedvr2_tpu_torch.utils.metrics import psnr

    stub = _comfy_stub()
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        comfy = stub.install(mp)
        loads = []
        real_load = loader.load_runner
        mp.setattr(loader, "load_runner", lambda **kw: loads.append(real_load(**kw)) or loads[-1])
        I.get_global_cache().clear()
        ext = asyncio.run(I.comfy_entrypoint())
        nodes = {cls.__name__: cls for cls in asyncio.run(ext.get_node_list())}
        comfy.node_id = "11"
        dit = nodes["SeedVR2LoadDiTModel"].execute(model="seedvr2_ema_3b_fp16.safetensors", cache_model=True).values[0]
        vae = nodes["SeedVR2LoadVAEModel"].execute(model="ema_vae_fp16.safetensors").values[0]
        if (dit["device"], vae["device"], dit["attention_mode"]) != ("cuda:0", "cuda:0", "fused"):
            raise RuntimeError(f"node defaults: DiT {dit}, VAE {vae}")
        upscaler = nodes["SeedVR2VideoUpscaler"]
        image = torch.from_numpy(frames.astype(np.float32) / 255.0)  # a ComfyUI IMAGE: CPU float32 [T, H, W, C]
        kw = dict(dit=dit, vae=vae, seed=42, resolution=PHASE9_RESOLUTION, batch_size=5, model_dir=d)

        # (a) the V3 workflow
        reset_counts()
        res, wall, peak = _peak_call(dev, lambda: upscaler.execute(image=image, **kw).values[0])
        counts = read_counts()
        (runner,) = loads
        shape = (len(frames),) + true_target_dims(*frames.shape[1:3], PHASE9_RESOLUTION) + (3,)
        if not (isinstance(res, torch.Tensor) and res.dtype == torch.float32 and res.device.type == "cpu"
                and tuple(res.shape) == shape):
            raise RuntimeError(f"node output {type(res)} {getattr(res, 'shape', None)} is not a ComfyUI IMAGE")
        expect("node (a)", counts, {k: per_batch[k] for k in PER_BATCH})
        ref = phases.generate(runner, image.numpy())
        diff = float(np.abs(res.numpy() - ref).max())
        ups = comfy.progress_bars[-1].updates
        if diff != 0 or ups != sorted(ups) or ups[-1] != 100:
            raise RuntimeError(f"node (a): max |diff| {diff} from phases.generate, progress {ups}")
        out["a"] = {"wall_s": wall, "peak_gib": peak, "launches": {k: counts[k] for k in PER_BATCH},
                    "max_abs_diff": diff, "progress": ups}
        print(f"  (a) V3 workflow, {frames.shape} -> {shape}: first execute {wall:.2f} s (the 3B and VAE loaded "
              f"warm from phase 9's weights cache, not converted), peak {peak:.2f} GiB, launches {out['a']['launches']}, max |diff| vs phases.generate "
              f"{diff}, progress {ups}", flush=True)

        # (b) the cache: another colour fix, no load
        res_lab, wall_b, _ = _peak_call(dev, lambda: upscaler.execute(image=image, color_correction="lab",
                                                                      **kw).values[0])
        ref_lab = phases.generate(runner.with_config(runner.cfg.replace(color_correction="lab")), image.numpy())
        diff_b = float(np.abs(res_lab.numpy() - ref_lab).max())
        if len(loads) != 1 or diff_b != 0 or runner.cfg.color_correction != "wavelet":
            raise RuntimeError(f"node (b): loads {len(loads)}, max |diff| {diff_b}, cached cfg "
                               f"{runner.cfg.color_correction}")
        out["b"] = {"wall_s": wall_b, "load_runner_calls": len(loads), "max_abs_diff": diff_b}
        print(f"  (b) cached execute, color_correction=lab: {wall_b:.2f} s, load_runner called once in all, max "
              f"|diff| vs phases.generate {diff_b}", flush=True)

        # (c) the interrupt, set from a progress update: first the first one
        # (phases 1-2 reported up front: no batch has run), then the first
        # after a batch (one batch ran)
        clip = np.random.RandomState(111).randint(0, 256, (PHASE11_INTERRUPT_FRAMES,) + frames.shape[1:])
        clip = torch.from_numpy(clip.astype(np.float32) / 255.0)
        update = stub.StubProgressBar.update_absolute
        out["c"] = {}
        for label, at in (("first update", 0), ("first update after a batch", 46)):
            seen = {}

            def hooked(bar, value, total, _at=at, _seen=seen):
                update(bar, value, total)
                if value >= _at and not comfy.interrupted:
                    comfy.interrupted = True
                    _seen["counts"], _seen["value"] = read_counts(), value

            mp.setattr(stub.StubProgressBar, "update_absolute", hooked)
            comfy.interrupted = False
            reset_counts()
            try:
                upscaler.execute(image=clip, **kw)
                raise RuntimeError(f"node (c) {label}: no InterruptProcessingException")
            except stub.InterruptProcessingException:
                pass
            after = read_counts()
            comfy.interrupted = False
            batches = 0 if at == 0 else 1
            want = {k: per_batch[k] * batches for k in PER_BATCH}
            if after != seen["counts"]:
                raise RuntimeError(f"node (c) {label}: launches after the flag: {seen['counts']} -> {after}")
            expect(f"node (c) {label}", after, want)
            out["c"][label] = {"flag_at_percent": seen["value"], "launches": {k: after[k] for k in want}}
            print(f"  (c) interrupt set at the {label} ({seen['value']}%): InterruptProcessingException raised, "
                  f"launches {out['c'][label]['launches']} at the flag and after it", flush=True)
        mp.setattr(stub.StubProgressBar, "update_absolute", update)
        del res, ref, res_lab, ref_lab

        # (d) the ladder, 3B at 1080p: the peaks of its stages, then the run
        # under a memory cap between them, then the run at the tiles it reached
        h, w = PHASE11_LADDER_HW
        big = np.random.RandomState(112).randint(0, 256, (5, h, w, 3)).astype(np.uint8)
        cfg_l = runner.cfg.replace(resolution=PHASE11_LADDER_RESOLUTION)
        plain = runner.with_config(cfg_l)
        peaks = {}
        _, _, peaks["fused route"] = _peak_call(dev, lambda: phases.generate(plain, big))
        with torch.inference_mode():
            tv = pipeline_transform(to_f01(phases.upload_frames(big, dev)), cfg_l.resolution, 0)[None]
            tv = tv.to(runner.compute_dtype)
            for tiled, size in PHASE11_RUNGS[:3]:
                lat, _, peaks[f"encode {size[0] if tiled else 'untiled'}"] = _peak_call(
                    dev, lambda: plain._encode(tv, tiled, size, (size[0] // 8,) * 2))
            del tv
            up, _, peaks["DiT step"] = _peak_call(dev, lambda: plain.upscale(lat, cfg_l.seed))
            for tiled, size in PHASE11_RUNGS:
                _, _, peaks[f"decode {size[0] if tiled else 'untiled'}"] = _peak_call(
                    dev, lambda: plain._decode(up, tiled, size, (size[0] // 8,) * 2))
        total_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
        cap = PHASE11_MEMORY_FRACTION * total_gib
        print(f"  (d) peaks at 1080p, GiB: " + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()), flush=True)
        if not (peaks["decode 1024"] > cap > max(peaks["encode 1024"], peaks["decode 512"], peaks["DiT step"])):
            raise RuntimeError(f"node (d): a cap of {cap:.2f} GiB does not force the rungs (peaks {peaks})")
        ladder = runner.with_config(cfg_l)
        ladder.debug = log = _recorded_log()
        attempts = []
        _record_vae_attempts(ladder, attempts)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(PHASE11_MEMORY_FRACTION, dev)
        print(f"  (d) memory cap: fraction {PHASE11_MEMORY_FRACTION} of {total_gib:.2f} GiB = {cap:.2f} GiB "
              f"({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated)", flush=True)
        try:
            reset_counts()
            got, wall_d, peak_d = _peak_call(dev, lambda: phases.generate(ladder, big, debug=log))
            counts_d = read_counts()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
        for line in log.lines:
            print(f"      rung: {line}", flush=True)
        for a in attempts:
            print(f"      VAE attempt: {a}", flush=True)
        fused_fell = any("fused pipeline" in line for line in log.lines)
        untiled_decode_oom = ("decode", False) in {a[:2] for a in attempts if a[4] == "oom"}
        enc = [a for a in attempts if a[0] == "encode" and a[4] == "ok"][-1]
        dec = [a for a in attempts if a[0] == "decode" and a[4] == "ok"]
        if not (fused_fell and untiled_decode_oom and dec and dec[-1][1]):
            raise RuntimeError(f"node (d): the cap did not force the fused fallback and a tiled decode rung: "
                               f"{log.lines}, {attempts}")
        dec = dec[-1]
        ref_cfg = cfg_l.replace(encode_tiled=enc[1], encode_tile_size=enc[2], encode_tile_overlap=enc[3],
                                decode_tiled=True, decode_tile_size=dec[2], decode_tile_overlap=dec[3])
        ref_d, ref_wall, ref_peak = _peak_call(dev, lambda: phases.generate(runner.with_config(ref_cfg), big))
        codes = _max_code_diff(got, ref_d)
        if codes != 0 or got.shape != (5,) + true_target_dims(h, w, PHASE11_LADDER_RESOLUTION) + (3,):
            raise RuntimeError(f"node (d): ladder output {got.shape} is {codes} codes from the run at its tiles")
        out["d"] = {"memory_fraction": PHASE11_MEMORY_FRACTION, "cap_gib": cap, "peaks_gib": peaks,
                    "rungs": log.lines, "attempts": attempts, "wall_s": wall_d, "peak_gib": peak_d,
                    "launches": {k: counts_d[k] for k in PER_BATCH}, "reference_wall_s": ref_wall,
                    "reference_peak_gib": ref_peak, "max_abs_diff_codes": codes}
        print(f"  (d) ladder: {big.shape} -> {got.shape} in {wall_d:.2f} s under the cap, peak {peak_d:.2f} GiB, "
              f"launches {out['d']['launches']}; encode {enc[1:4]}, decode {dec[1:4]}; the same tiles without the "
              f"cap (fused route) {ref_wall:.2f} s, peak {ref_peak:.2f} GiB; max |diff| {codes} codes", flush=True)
        del got, ref_d, lat

        # (e) the host-staged decode against the device-tiled decode, on that batch's latent
        ts, to = PHASE11_STAGED_TILE
        vc = cfg_l.vae
        with torch.inference_mode():
            z = up / vc.scaling_factor + vc.shifting_factor
            del up
            tiled, tiled_s, tiled_peak = _peak_call(dev, lambda: tiling.tiled_decode(runner.vae, z, ts, to))
            staged, staged_s, staged_peak = _peak_call(dev, lambda: tiling.tiled_decode_staged(runner.vae, z, ts, to))
        tiled = tiled.float().cpu()
        rel = _rel((staged.to(torch.bfloat16).float(),), (tiled,))
        rel_fp32 = _rel((staged,), (tiled,))
        db = psnr(staged.clamp(-1, 1).numpy() * 0.5 + 0.5, tiled.clamp(-1, 1).numpy() * 0.5 + 0.5)
        if not (rel <= 1e-3 and staged_peak < tiled_peak and torch.isfinite(staged).all()):
            raise RuntimeError(f"node (e): staged vs device-tiled rel L2 {rel:.3e}, peaks {staged_peak:.2f} / "
                               f"{tiled_peak:.2f} GiB")
        out["e"] = {"tile": ts, "overlap": to, "rel_l2_bf16": rel, "rel_l2_fp32_vs_bf16": rel_fp32, "psnr_db": db,
                    "staged_s": staged_s, "tiled_s": tiled_s, "staged_peak_gib": staged_peak,
                    "tiled_peak_gib": tiled_peak}
        print(f"  (e) staged vs device-tiled decode at {ts} px tiles: rel L2 {rel:.3e} (the staged fp32 sums rounded "
              f"to bf16 as the tiled decode's; unrounded {rel_fp32:.3e}), PSNR {db:.2f} dB; staged {staged_s:.2f} s, "
              f"peak {staged_peak:.2f} GiB; device-tiled {tiled_s:.2f} s, peak {tiled_peak:.2f} GiB", flush=True)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        mp.undo()
        I.get_global_cache().clear()
    return out


# --------------------------------------------------------------------------- #
# Phase 12: the streamed output path
# --------------------------------------------------------------------------- #

# (a) the main path's clip with the tiled decode at its default 1024 / 128 px
# tiles: one row of two 704 px column tiles; (b) 960x540 -> 1920x1080 with
# 1088 x 1024 px tiles: two 1024 px column tiles. (column starts in latent
# units, chunk end columns in pixels; tiling.column_chunk_plan)
PHASE12_PLANS = {"720p": ((0, 72), (544, 1280)), "1080p": ((0, 112), (864, 1920))}
PHASE12_1080_TILE = (1088, 1024)
# (c) the deferred flush: three 5-frame batches at (a)'s geometry
PHASE12_FLUSH_FRAMES = 15


def _spy_routes(runner):
    """Count the batches that ``runner`` sends through each fused route."""
    seen = {"chunks": 0, "fused": 0}
    chunks, fused = runner.fused_batch_chunks, runner.fused_batch

    def count_chunks(*a, **k):
        seen["chunks"] += 1
        return chunks(*a, **k)

    def count_fused(*a, **k):
        seen["fused"] += 1
        return fused(*a, **k)

    runner.fused_batch_chunks, runner.fused_batch = count_chunks, count_fused
    return seen


def _routes(runner, frames, label, out_hw, want_plan, **generate_kw):
    """phases.generate on the chunk route ("auto") and on one fused_batch a
    batch ("off"), two runs each (the first counted and its peak read);
    each route's batches asserted on their route, the codes compared and
    the K1 / K2 / K3 / K8 / K9 counts asserted equal and non-zero."""
    from seedvr2_tpu_torch.ops.yuv import is_planar
    from seedvr2_tpu_torch.pipeline import phases

    plan = runner.supports_chunked((5,) + frames.shape[1:3] + (3,), *out_hw)
    if plan is None or (plan.cols, plan.emit) != want_plan:
        raise RuntimeError(f"{label}: plan {plan}, expected cols / emit {want_plan}")
    res, outs = {"plan": {"cols": plan.cols, "emit": plan.emit, "tile_px": plan.tw}}, {}
    for route in ("auto", "off"):
        r = runner.with_config(runner.cfg.replace(chunked_output=route))
        seen = _spy_routes(r)
        walls = []
        for run in range(2):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            out = phases.generate(r, frames, packed=True, **generate_kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if run == 0:
                launches, peak = read_counts(), torch.cuda.max_memory_allocated(r.device) / 2**30
        batches = -(-len(frames) // 5) * 2
        if seen != ({"chunks": batches, "fused": 0} if route == "auto" else {"chunks": 0, "fused": batches}):
            raise RuntimeError(f"{label} {route}: batches by route {seen}")
        outs[route] = out
        res[route] = {"wall_s": walls, "peak_gib": peak,
                      "launches": {k: launches[k] for k in ("K1", "K2", "K3", "K4", "K3q", "K5", "K7", "K8", "K9")}}
    auto, off = outs["auto"], outs["off"]
    if tuple(auto.shape) != tuple(off.shape) or tuple(auto.shape[1:3]) != out_hw:
        raise RuntimeError(f"{label}: shapes {auto.shape} vs {off.shape}")
    planar = is_planar(auto)
    if planar != (runner.cfg.output_pixfmt == "yuv420") or planar != is_planar(off):
        raise RuntimeError(f"{label}: planes {planar} / {is_planar(off)} for output_pixfmt {runner.cfg.output_pixfmt}")
    pairs = zip((auto.y, auto.u, auto.v), (off.y, off.u, off.v)) if planar else [(auto, off)]
    diff = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) for a, b in pairs)
    bound = 1 if planar else 2
    res["max_code_diff"] = diff
    la, lo = res["auto"]["launches"], res["off"]["launches"]
    if diff > bound or any(la[k] != lo[k] or la[k] == 0 for k in PER_BATCH):
        raise RuntimeError(f"{label}: chunked vs off {diff} codes (bound {bound}), launches {la} vs {lo}")
    print(f"  {label}: plan cols {plan.cols} emit {plan.emit} ({plan.tw} px tiles); auto {res['auto']['wall_s'][0]:.3f}"
          f" / {res['auto']['wall_s'][1]:.3f} s, peak {res['auto']['peak_gib']:.2f} GiB; off "
          f"{res['off']['wall_s'][0]:.3f} / {res['off']['wall_s'][1]:.3f} s, peak {res['off']['peak_gib']:.2f} GiB; "
          f"max code diff {diff}; K1 {la['K1']} K2 {la['K2']} K3 {la['K3']} on both", flush=True)
    return res


def stream_phase(dev, text, frames):
    """Phase 12: the streamed column-chunk decode and the deferred output
    copy at full width (3B + VAE, bf16, wavelet, 16-bit codes), each route
    of phases.generate against the other: (a) 720p, (b) 1080p, (c) the
    deferred flush over three batches under the profiler, with the sync
    census of the chunk route, (d) yuv420 planes. Every check raises."""
    from seedvr2_tpu_torch.config import PipelineConfig
    from seedvr2_tpu_torch.io.weights import random_dit, random_vae
    from seedvr2_tpu_torch.pipeline import phases
    from seedvr2_tpu_torch.pipeline.runner import Runner
    from seedvr2_tpu_torch.stream_ab import sync_census, trace_copies

    cfg = PipelineConfig(resolution=720, decode_tiled=True)
    g = torch.Generator(device=dev).manual_seed(46)
    runner = Runner(cfg, random_dit(cfg.dit, g), random_vae(cfg.vae, g), text, device=dev)
    out = {}
    print("  (a) 720p, decode_tiled at 1024 / 128 px", flush=True)
    out["a"] = _routes(runner, frames, "720p", (720, 1280), PHASE12_PLANS["720p"])
    print("  (b) 1080p, decode tiles 1088 x 1024 px", flush=True)
    big = np.random.RandomState(12).randint(0, 256, (5, 540, 960, 3)).astype(np.uint8)
    r1080 = runner.with_config(cfg.replace(resolution=1080, decode_tile_size=PHASE12_1080_TILE))
    out["b"] = _routes(r1080, big, "1080p", (1080, 1920), PHASE12_PLANS["1080p"])
    del big, r1080
    gc.collect()
    torch.cuda.empty_cache()

    clip = np.random.RandomState(13).randint(0, 256, (PHASE12_FLUSH_FRAMES, 360, 640, 3)).astype(np.uint8)
    out["c"] = {}
    for route in ("auto", "off"):
        r = runner.with_config(cfg.replace(chunked_output=route))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        phases.generate(r, clip, packed=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        tr = trace_copies(r, clip)
        tr.update(unprofiled_wall_s=wall, launches={k: launches[k] for k in PER_BATCH})
        out["c"][route] = tr
        print(f"  (c) {PHASE12_FLUSH_FRAMES} frames, 3 batches, {route}: {wall:.3f} s ({tr['wall_s']:.3f} s profiled); "
              f"{tr['d2h_count']} D2H copies, {tr['d2h_bytes'] / 1e6:.1f} MB, {tr['d2h_ms']:.3f} ms, "
              f"{tr['d2h_overlapping_compute_ms']:.3f} ms of it under a compute-stream kernel (streams "
              f"{tr['d2h_streams']} vs compute {tr['compute_stream']})", flush=True)
    if out["c"]["auto"]["d2h_count"] < 3 * len(PHASE12_PLANS["720p"][1]):
        raise RuntimeError(f"(c) chunk route: {out['c']['auto']['d2h_count']} D2H copies for 3 batches")
    for route in ("auto", "off"):
        out["c"][f"syncs_{route}"] = sync_census(runner.with_config(cfg.replace(chunked_output=route)), clip)
        print(f"  (c) synchronizing calls in one {route} run (file:line -> count): {out['c'][f'syncs_{route}']}",
              flush=True)
    del clip

    print("  (d) yuv420 planes, 720p", flush=True)
    yuv = runner.with_config(cfg.replace(output_pixfmt="yuv420"))
    out["d"] = _routes(yuv, frames, "720p yuv420", (720, 1280), PHASE12_PLANS["720p"])
    return out


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

    print("[3] kernels vs plain versions: conv_ab's rows, this tree, one round", flush=True)
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
    torch.cuda.empty_cache()

    print("[8] multi-rank: two ranks on the one card (gloo), K3s and K5 per rank, sharded DiT steps, "
          "generate_multichip data=2, the tile-parallel VAE",
          flush=True)
    rank_rows, e2e_multi = multi_rank_phase(dev, text)
    gc.collect()
    torch.cuda.empty_cache()

    with scratch_dir() as d:
        print("[9] the CLI: python -m seedvr2_tpu_torch.cli's argv in this process, 3B + VAE through safetensors, "
              "640x360 -> 1280x720", flush=True)
        t0 = time.perf_counter()
        e2e_cli = cli_phase(dev, launches, d)
        e2e_cli["wall_s"] = time.perf_counter() - t0

        print("[10] int8 weights: 7B quantize='int8' under sageattn_2 (K7, K3q), then 3B through the CLI with "
              "--quantize int8 and from a .gguf", flush=True)
        t0 = time.perf_counter()
        e2e_int8, launches_int8 = int8_phase(dev, text, frames, d, launches)
        e2e_int8["wall_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

        print("[11] the ComfyUI node layer under the stub host: 3B + VAE from phase 9's safetensors; the V3 "
              "workflow, the cache, the interrupt, the OOM ladder at 1080p under a memory cap, the staged decode",
              flush=True)
        t0 = time.perf_counter()
        e2e_node = node_phase(dev, launches, d, frames)
        e2e_node["wall_s"] = time.perf_counter() - t0
        print(f"  phase 11: {e2e_node['wall_s']:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        print("[12] the streamed output path: 3B + VAE, the column-chunk route against one fused_batch a batch "
              "(720p, 1080p, three batches under the profiler, yuv420)", flush=True)
        t0 = time.perf_counter()
        e2e_stream = stream_phase(dev, text, frames)
        e2e_stream["wall_s"] = time.perf_counter() - t0
        print(f"  phase 12: {e2e_stream['wall_s']:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        print("[13] the load path's cold start: phase 9's 3B safetensors and VAE in a fresh directory, cold and "
              "warm loads in child processes, then in this process after the source is touched", flush=True)
        t0 = time.perf_counter()
        e2e_load = load_phase(dev, frames, d, launches)
        e2e_load["wall_s"] = time.perf_counter() - t0
        print(f"  phase 13: {e2e_load['wall_s']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    e2e.update({f"7b_{k}": v for k, v in e2e_7b.items()}, long_clip=dict(e2e_long, launches=launches_long),
               multi_rank=e2e_multi, cli=e2e_cli, int8=e2e_int8, node=e2e_node, stream=e2e_stream, load=e2e_load)
    main_counts = dict(launches, K4=launches_gn["K4"], K8=launches_gn["K8"], K3q=launches_q["K3q"],
                       K5=launches_f["K5"], K11=launches_f["K11"])
    fill_launches(rows, {"720p": main_counts, "long_clip": launches_long},
                  {"7b": launches_int8, "3b": e2e_int8["3B --quantize int8 (safetensors)"]["launches"]})
    print(json.dumps({"kernels": rows + rank_rows, "e2e": e2e, "small": small, "build_s": b.seconds,
                      "build_nvcc_s": b.compile_seconds}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
