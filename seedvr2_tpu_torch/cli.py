"""The port's command-line upscaler: ``inference_cli.py``'s argv on PyTorch
and CUDA.

    python -m seedvr2_tpu_torch.cli video.mp4 --resolution 1080 --batch_size 5
    python -m seedvr2_tpu_torch.cli frame.png --resolution 720 --cuda_device 1
    torchrun --nproc_per_node 4 -m seedvr2_tpu_torch.cli video.mp4 --mesh 4,1,1

Inputs are an image, a video or a directory of both; outputs are a PNG, an
mp4 (10-bit x265 through ffmpeg, else 8-bit through cv2) or, with
``--output_format png``, a PNG sequence. ``--chunk_size`` streams a video
in chunks, ``--temporal_overlap`` Hann-blends their seams, ``--resume``
continues an interrupted chunked run. ``--cuda_device`` picks the card
(an index, default 0) or ``cpu``, where every kernel runs its plain
PyTorch version. Under torchrun (WORLD_SIZE set) every rank runs this
command: the ranks form the ``--mesh`` (data x seq x tensor, or ``auto``)
over NCCL, or gloo on the CPU, and rank 0 writes the output.

Flags of the reference CLI that have no meaning here are accepted and
ignored with a note: BlockSwap, torch.compile, offload devices and model
caching (the port runs eagerly with the weights resident), and
``--vae_conv_backend xla`` (the port never falls back to a library conv).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

_IGNORED = ["--blocks_to_swap", "--swap_io_components", "--dit_offload_device", "--vae_offload_device",
            "--compile_dit", "--compile_vae", "--compile_mode", "--compile_backend", "--compile_fullgraph",
            "--compile_dynamic", "--compile_dynamo_cache_size_limit", "--compile_dynamo_recompile_limit",
            "--cache_dit", "--cache_vae"]


def parse_arguments(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The argument table of inference_cli.py (dest, default, choices and
    nargs of every option; tests/test_torch_cli.py holds the two equal)."""
    p = argparse.ArgumentParser(description="SeedVR2 video/image upscaler (PyTorch + CUDA)")
    p.add_argument("input", type=str, help="video file, image file, or directory")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--output_format", type=str, default="video", choices=["video", "png"])
    p.add_argument("--resolution", type=int, default=1080)
    p.add_argument("--max_resolution", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=5)
    p.add_argument("--uniform_batch_size", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model_dir", type=str, default="./models")
    p.add_argument("--dit_model", type=str, default=None)
    p.add_argument("--vae_model", type=str, default="ema_vae_fp16.safetensors")
    p.add_argument("--chunk_size", type=int, default=0, help="streaming chunk frames (0 = whole video)")
    p.add_argument("--temporal_overlap", type=int, default=0)
    p.add_argument("--prepend_frames", type=int, default=0)
    p.add_argument("--skip_first_frames", type=int, default=0)
    p.add_argument("--load_cap", type=int, default=0)
    p.add_argument("--color_correction", type=str, default="wavelet",
                   choices=["wavelet", "lab", "hsv", "wavelet_adaptive", "adain", "none"])
    p.add_argument("--input_noise_scale", type=float, default=0.0)
    p.add_argument("--latent_noise_scale", type=float, default=0.0)
    # one int (square) or two (h w)
    p.add_argument("--vae_encode_tiled", action="store_true")
    p.add_argument("--vae_encode_tile_size", type=int, nargs="+", default=[1024])
    p.add_argument("--vae_encode_tile_overlap", type=int, nargs="+", default=[128])
    p.add_argument("--vae_decode_tiled", action="store_true")
    p.add_argument("--vae_decode_tile_size", type=int, nargs="+", default=[1024])
    p.add_argument("--vae_decode_tile_overlap", type=int, nargs="+", default=[128])
    p.add_argument("--vae_conv_backend", type=str, default="pallas", choices=["xla", "pallas"],
                   help="accepted for compatibility: the port's VAE convs always run its own kernels")
    p.add_argument("--attention_mode", type=str, default="fused",
                   choices=["fused", "pallas", "xla", "sdpa", "flash_attn_2", "flash_attn_3", "sageattn_2",
                            "sageattn_3"])
    p.add_argument("--output_bits", type=str, default="auto", choices=["auto", "8", "16"],
                   help="device->host codes: 16 for the 10-bit x265 / PNG sinks, 8 for the cv2 8-bit sink; "
                        "auto picks by the sink")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--resume", action="store_true", help="resume an interrupted chunked run")
    p.add_argument("--quantize", type=str, default="none", choices=["none", "int8"],
                   help="int8 weight-only DiT storage (the block linears run K7, a W8A16 kernel); a .gguf "
                        "DiT is always int8")
    p.add_argument("--fps", type=float, default=0.0, help="override output fps")
    p.add_argument("--10bit", dest="use_10bit", action="store_true",
                   help="10-bit x265 output (the ffmpeg writer's default); forces the 16-bit transfer under "
                        "--output_bits auto")
    p.add_argument("--mesh", type=str, default="auto", help="auto or 'data,seq,tensor' over the torchrun ranks")
    p.add_argument("--tile_debug", type=str, default="false", choices=["false", "encode", "decode"],
                   help="draw VAE tile boundaries on the output")
    p.add_argument("--tensor_offload_device", type=str, default=None,
                   help="'cpu' keeps intermediates in host memory, 'none' on the card (default: by the run budget)")
    p.add_argument("--fused_pipeline", type=str, default="auto", choices=["auto", "off"],
                   help="'off' forces the 4-phase pipeline")
    p.add_argument("--video_backend", type=str, default="auto", choices=["auto", "opencv", "ffmpeg"])
    p.add_argument("--pixfmt", type=str, default="auto", choices=["auto", "rgb", "yuv420"],
                   help="'yuv420' moves the codec's planes over the host link and converts on the card; "
                        "'auto' = yuv420 exactly when the sink is yuv420 video through ffmpeg")
    p.add_argument("--cuda_device", nargs="?", default=None,
                   help="the card: an index (default 0), or 'cpu' to run the plain versions on the CPU")
    for flag in _IGNORED:
        p.add_argument(flag, nargs="?", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _pair(v):
    v = list(v)
    return (v[0], v[0]) if len(v) == 1 else (v[0], v[1])


def _device(args) -> torch.device:
    if args.cuda_device is not None and str(args.cuda_device).lower() == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(args.cuda_device or 0))


def _resolve_output_bits(args) -> int:
    """'auto': 16-bit codes where the sink keeps them (PNG, the 10-bit x265
    ffmpeg writer), 8 for the cv2 8-bit mp4."""
    from .io import video as vio

    if args.output_bits != "auto":
        bits = int(args.output_bits)
        if args.use_10bit and bits == 8:
            print("⚠️ --10bit ignored: explicit --output_bits 8 forces the 8-bit transfer")
        return bits
    if args.output_format == "png" or vio.have_ffmpeg():
        return 16
    if args.use_10bit:
        print("⚠️ --10bit requested but ffmpeg is unavailable; falling back to 8-bit cv2 mp4")
        return 16
    return 8


def _resolve_pixfmt(args) -> str:
    """'auto' -> 'yuv420' exactly when the sink is yuv420 video written by
    ffmpeg. Chunk seams (--chunk_size with --temporal_overlap) are blended
    on RGB codes on the host, so planes are asked for only where no seam
    blend can follow: with seams the run stays 'rgb' (inference_cli.py asks
    for planes there, and its blend then fails on them)."""
    if args.pixfmt == "rgb":
        return "rgb"
    from .io import video as vio

    ffmpeg_sink = args.output_format == "video" and args.video_backend != "opencv" and vio.have_ffmpeg()
    seams = bool(args.chunk_size) and args.temporal_overlap > 0
    if args.pixfmt == "yuv420" and not ffmpeg_sink:
        print("⚠️ --pixfmt yuv420 needs an ffmpeg video sink; using rgb")
    elif args.pixfmt == "yuv420" and seams:
        print("⚠️ --pixfmt yuv420: chunk seams are blended in RGB; using rgb")
    return "yuv420" if ffmpeg_sink and not seams else "rgb"


def _configs(dit_name: str):
    """(dit, vae) configs for a DiT file name: 'tiny' in it picks the
    test-sized models; otherwise 3B (load_runner turns it to 7B by name)."""
    from .config import dit_3b, dit_7b, dit_tiny, vae_config, vae_tiny
    from .io.registry import model_variant

    variant = model_variant(dit_name)
    if variant == "tiny":
        vae_cfg = vae_tiny()
        return dataclasses.replace(dit_tiny(), vid_in_channels=2 * vae_cfg.latent_channels + 1,
                                   vid_out_channels=vae_cfg.latent_channels), vae_cfg
    return (dit_7b() if variant == "7b" else dit_3b()), vae_config()


def _dit_name(args) -> str:
    from .io.registry import DEFAULT_DIT

    return args.dit_model or DEFAULT_DIT


def build_config(args):
    """The PipelineConfig of the parsed arguments."""
    from .config import PipelineConfig
    from .pipeline.loader import pick_config

    dit_cfg, vae_cfg = _configs(_dit_name(args))
    offload = "auto"
    if args.tensor_offload_device is not None:
        v = args.tensor_offload_device.lower()
        if v in ("none", "cuda", "gpu", "tpu"):
            offload = "never"
        elif v not in ("auto", ""):  # "cpu" or any host device
            offload = "always"
    cfg = PipelineConfig(
        dit=dit_cfg,
        vae=vae_cfg,
        tensor_offload=offload,
        fused_pipeline=args.fused_pipeline,
        resolution=args.resolution,
        max_resolution=args.max_resolution,
        batch_size=args.batch_size,
        uniform_batch_size=args.uniform_batch_size,
        temporal_overlap=args.temporal_overlap,
        prepend_frames=args.prepend_frames,
        seed=args.seed,
        input_noise_scale=args.input_noise_scale,
        latent_noise_scale=args.latent_noise_scale,
        color_correction=args.color_correction,
        encode_tiled=args.vae_encode_tiled,
        encode_tile_size=_pair(args.vae_encode_tile_size),
        encode_tile_overlap=_pair(args.vae_encode_tile_overlap),
        decode_tiled=args.vae_decode_tiled,
        decode_tile_size=_pair(args.vae_decode_tile_size),
        decode_tile_overlap=_pair(args.vae_decode_tile_overlap),
        output_bits=_resolve_output_bits(args),
        output_pixfmt=_resolve_pixfmt(args),
    )
    return pick_config(_dit_name(args), cfg)


def build_runner(args, mesh=None, runner=None):
    """(runner, cfg, debug) for the parsed arguments: the weights read
    through pipeline/loader.py, or ``runner``'s modules (loaded by an
    earlier call with the same model files) under this call's settings."""
    from .pipeline.loader import load_runner
    from .utils.debug import Debug

    device = mesh.device if mesh is not None else _device(args)
    debug = Debug(enabled=args.debug, device=device)
    debug.environment_report(args.attention_mode)
    if args.vae_conv_backend == "xla":
        print("note: --vae_conv_backend xla is ignored: the VAE convs run the port's own kernels")
    for flag in _IGNORED:
        if getattr(args, flag[2:]) is not None:
            print(f"note: {flag} has no meaning here (the weights stay resident, the port runs eagerly); ignored")
    cfg = build_config(args)
    if runner is not None:
        return runner.with_config(cfg), cfg, debug
    debug.start_timer("load")
    runner = load_runner(_dit_name(args), args.vae_model, args.model_dir, cfg, device=device,
                         quantize=None if args.quantize == "none" else args.quantize,
                         attention_mode=args.attention_mode, mesh=mesh, debug=debug)
    debug.end_timer("load", "Weights loaded")
    if mesh is not None:
        debug.log(f"mesh: data={mesh.shape['data']} seq={mesh.shape['seq']} tensor={mesh.shape['tensor']}",
                  category="sharding", force=mesh.rank == 0)
    return runner, runner.cfg, debug


def _to_rgb_if_planar(out):
    """Image sinks take RGB: planes (a video-oriented run on a still image)
    are converted on the host."""
    from .ops.yuv import is_planar, yuv420_to_rgb01_np

    return yuv420_to_rgb01_np(out.to_numpy()) if is_planar(out) else out


def process_frames(runner, cfg, frames, debug, mesh=None, tile_debug="false"):
    """One clip through the pipeline: [T, H, W, 3|4] frames (or planes) ->
    the upscaled clip, packed codes where the route packs on the card
    (float32 for the tile overlay, which draws in float). With a mesh every
    rank calls this and only rank 0 gets the clip (None elsewhere)."""
    from .pipeline import phases

    packed = tile_debug not in ("encode", "decode")
    debug.start_timer("generate")
    if mesh is not None and mesh.shape["data"] > 1:
        from .pipeline.multichip import generate_multichip

        out = generate_multichip(runner, frames, mesh)
    else:
        out = phases.generate(runner, frames, cfg, packed=packed)
        if mesh is not None and mesh.rank != 0:
            out = None
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)
    dt = debug.end_timer("generate")
    debug.log(f"Generated {len(frames)} frames in {dt:.2f}s ({len(frames) / max(dt, 1e-9):.2f} fps)",
              category="generation")
    debug.peak_memory_summary()
    if out is not None and tile_debug in ("encode", "decode"):
        from .utils.tile_debug import draw_for_config

        out = draw_for_config(np.asarray(out), cfg, tile_debug)
    return out


def build_mesh(args, n_frames: Optional[int] = None):
    """The mesh of this invocation: None on one rank. Under torchrun
    (WORLD_SIZE > 1) the ranks join over NCCL (gloo with --cuda_device
    cpu) and form ``--mesh``: 'd,s,t' as given, or 'auto' from the frame
    count and the DiT (parallel/mesh.py:build_mesh)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    from .parallel import mesh as pmesh
    from .parallel.multihost import initialize

    cpu = _device(args).type == "cpu"
    initialize("gloo" if cpu else "nccl")
    return pmesh.build_mesh(args.mesh, n_frames, _configs(_dit_name(args))[0], device="cpu" if cpu else None,
                            quantize=None if args.quantize == "none" else args.quantize, dit_model=_dit_name(args))


def _probe_frames(args, kind: str) -> Optional[int]:
    """Frames of one processing call, for the mesh policy: 1 for an image,
    a video's count bounded by --load_cap and --chunk_size, None for a
    directory (the data-first default)."""
    if kind == "image":
        return 1
    if kind != "video":
        return None
    from .io import video as vio

    try:
        reader = vio.make_video_reader(args.input, backend=args.video_backend)
    except (OSError, RuntimeError, ValueError):
        return None
    total = reader.total_frames - args.skip_first_frames
    reader.close()
    if args.load_cap:
        total = min(total, args.load_cap)
    if args.chunk_size:
        total = min(total, args.chunk_size)
    return max(int(total), 1)


def _default_out(path: str, ext: str) -> str:
    base, _ = os.path.splitext(path)
    return f"{base}_upscaled.{ext}"


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


def run(argv: Optional[List[str]] = None, runner=None):
    """The command for ``argv``; returns (frames written, the runner). A
    ``runner`` from an earlier run with the same model files is reused
    (no weights are read again; it brings its own mesh)."""
    args = parse_arguments(argv)
    from .io import video as vio

    kind = vio.input_type(args.input)
    joined = runner is None  # this call joins (and leaves) a torchrun job where one is set
    mesh = build_mesh(args, _probe_frames(args, kind)) if joined else runner.mesh
    try:
        runner, cfg, debug = build_runner(args, mesh, runner)
        lead = mesh is None or mesh.rank == 0
        t0 = time.time()
        n_frames = 0
        if kind == "image":
            out_path = args.output or _default_out(args.input, "png")
            n_frames = _process_image(args, runner, cfg, debug, mesh, args.input, out_path, lead)
            if lead:
                print(f"Saved {out_path}")
        elif kind == "video":
            out_path = args.output or _default_out(args.input, "mp4")
            n_frames = _process_video(args, runner, cfg, debug, mesh, args.input, out_path)
        else:  # a directory of videos and images
            files = sorted(f for f in os.listdir(args.input)
                           if os.path.splitext(f)[1].lower() in (vio.IMAGE_EXTS | vio.VIDEO_EXTS))
            out_dir = args.output or (args.input.rstrip("/") + "_upscaled")
            if lead:
                os.makedirs(out_dir, exist_ok=True)
            for f in files:
                src = os.path.join(args.input, f)
                base, ext = os.path.splitext(f)
                if ext.lower() in vio.IMAGE_EXTS:
                    n_frames += _process_image(args, runner, cfg, debug, mesh, src, os.path.join(out_dir, f), lead)
                else:  # the original name in an .mp4 container
                    out = os.path.join(out_dir, base + ".mp4")
                    n_frames += _process_video(args, runner, cfg, debug, mesh, src, out)
            if lead:
                print(f"Saved {len(files)} files to {out_dir}")
        dt = time.time() - t0
        if n_frames and lead:
            print(f"Processed {n_frames} frames in {dt:.1f}s ({n_frames / dt:.2f} fps)")
            peak = debug.peak_memory_gib()
            if peak is not None:
                print(f"Peak device memory: {peak:.2f} GiB")
    finally:
        if mesh is not None and joined:
            import torch.distributed as dist

            dist.destroy_process_group()
    return n_frames, runner


def _process_image(args, runner, cfg, debug, mesh, in_path: str, out_path: str, lead: bool) -> int:
    """One image (the tile overlay is drawn on videos only, as in
    inference_cli.py)."""
    from .io import video as vio

    out = process_frames(runner, cfg, vio.read_image(in_path)[None], debug, mesh)
    if lead:
        vio.write_image(out_path, _to_rgb_if_planar(out)[0])
    return 1


def _process_video(args, runner, cfg, debug, mesh, in_path: str, out_path: str) -> int:
    """Chunked upscale of one video file; returns the frames written. The
    decoder's bytes (or planes) go to the card as they are and are scaled
    there. With a mesh every rank runs the chunks and rank 0 writes."""
    from .io import video as vio
    from .ops.blending import overlap_weights
    from .ops.yuv import is_planar

    lead = mesh is None or mesh.rank == 0
    n_frames = 0
    # planes in only where the fused path will see them (no mesh, no overlap
    # or prepended frames, no 4-phase run, no overlay), else the host would
    # convert them back
    want_planar = (
        cfg.output_pixfmt == "yuv420"
        and mesh is None
        and args.temporal_overlap == 0
        and args.prepend_frames == 0
        and args.fused_pipeline != "off"
        and args.tile_debug == "false"
    )
    reader = vio.make_video_reader(in_path, dtype=np.uint8, backend=args.video_backend, planar=want_planar)
    if getattr(reader, "planar", False):
        print("ffmpeg reader: yuv420 planes go to the card (colour conversion on the card)")
    if reader.dtype == np.uint16 and not getattr(reader, "planar", False):
        print("ffmpeg reader: the >8-bit source decodes to uint16 (16-bit device path)")
    if args.skip_first_frames:
        reader.seek(args.skip_first_frames)
    fps = args.fps or reader.fps
    chunk = args.chunk_size or (args.load_cap or reader.total_frames)

    manifest = None
    start_chunk = 0
    if args.chunk_size and args.output_format == "video" and args.temporal_overlap == 0:
        from .io.resume import ResumeManifest

        total = reader.total_frames - args.skip_first_frames
        if args.resume:
            manifest = ResumeManifest.load_if_matching(out_path, in_path, total, chunk)
            if manifest:
                start_chunk = manifest.chunks_done
                reader.seek(args.skip_first_frames + start_chunk * chunk)
                n_frames = start_chunk * chunk
                if lead:
                    print(f"Resuming from chunk {start_chunk} ({n_frames} frames done)")
        if manifest is None:
            manifest = ResumeManifest(out_path, in_path, total, chunk)

    writer = None
    ci = start_chunk
    ov = args.temporal_overlap if args.chunk_size else 0
    pending_tail = None  # the last ``ov`` output frames, held back for the seam blend

    def emit(arr):
        nonlocal writer, n_frames
        if len(arr) == 0:
            return
        if not lead:  # rank 0 writes; the others only count
            n_frames += len(arr)
            return
        planar = is_planar(arr)
        wkw = dict(planar_in=True, bit10=arr.depth == 10) if planar else {}
        if args.output_format == "png":
            vio.write_png_sequence(os.path.splitext(out_path)[0], arr, start_index=n_frames)
        elif manifest is not None:
            seg = manifest.segment_path(ci)
            w = vio.make_video_writer(seg, arr.shape[2], arr.shape[1], fps, backend=args.video_backend, **wkw)
            w.write(arr if planar else arr[..., :3])
            w.close()
            manifest.mark_done(ci, seg)
        else:
            if writer is None:
                writer = vio.make_video_writer(out_path, arr.shape[2], arr.shape[1], fps, backend=args.video_backend,
                                               audio_source=in_path, **wkw)
            writer.write(arr if planar else arr[..., :3])
        n_frames += len(arr)

    try:
        for frames in reader.chunks(chunk, ov):
            if args.load_cap and n_frames >= args.load_cap:
                break
            out = process_frames(runner, cfg, frames, debug, mesh, args.tile_debug)
            if out is None:  # another rank than 0 of a mesh: empty frames keep the same count of chunks and frames
                out = np.zeros((len(frames), 0, 0, 3), np.uint8)
            if not is_planar(out):
                out = np.asarray(out)
            if pending_tail is not None:
                # the chunk's first ``ov`` outputs re-render the held-back tail: Hann-blend, emit once
                # (_resolve_pixfmt keeps such runs on RGB codes)
                k = min(ov, len(out), len(pending_tail))
                w_prev = overlap_weights(k).reshape(k, 1, 1, 1).astype(np.float32)
                blend = pending_tail[-k:].astype(np.float32) * w_prev + out[:k].astype(np.float32) * (1.0 - w_prev)
                if out.dtype != np.float32:  # packed codes: round back
                    blend = blend + 0.5
                out = np.concatenate([blend.astype(out.dtype), out[k:]], axis=0)
            if ov > 0 and len(frames) == chunk:  # more chunks may follow: hold the tail back
                pending_tail, out = out[-ov:], out[:-ov]
            else:
                pending_tail = None
            emit(out)
            ci += 1
            if not args.chunk_size:
                break
        if pending_tail is not None:
            emit(pending_tail)
        if writer is not None:
            writer.close()
            writer = None
        if manifest is not None and lead:
            out_path = manifest.finalize()
    finally:
        reader.close()
    if lead:
        print(f"Saved {out_path}")
    return n_frames


if __name__ == "__main__":
    sys.exit(main())
