"""The port's CLI (seedvr2_tpu_torch/cli.py) on the CPU: its argument table
against inference_cli.py's; its own loop (chunks, seam blends,
--skip_first_frames, --load_cap, --resume, PNG sequences, directories)
against inference_cli.py's on the same decoded clips, with one stand-in
for process_frames in both; and runs of ``main`` on tiny checkpoints that
the port's own export wrote (``--cuda_device cpu``): an image, an RGBA
image, a video, a mixed directory, chunked streaming with seam blends,
``--resume``, ``--tile_debug``, the yuv420 sink, and ``--mesh 2,1,1`` on
two gloo ranks against one rank.

The outputs are held against phases.generate on the same decoded frames
(through a recording video writer, since the mp4 codecs are lossy), and
chunked runs against inference_cli.py's chunk loop around the port's
pipeline: the CLI adds only I/O and the seam blend, so they agree exactly
(8-bit PNG codes within 1 where two gloo ranks sum tile accumulators in
another order).
"""

import argparse
import dataclasses
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

import inference_cli
from fake_hub import FakeHub
from seedvr2_tpu.io import registry as jregistry
from seedvr2_tpu.io import video as jvideo
from seedvr2_tpu_torch import cli, config
from seedvr2_tpu_torch.io import frameops, video
from seedvr2_tpu_torch.io.weights import save_random_checkpoint
from seedvr2_tpu_torch.ops.yuv import is_planar
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.utils.debug import Debug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table(parse):
    """dest -> (option strings, default, choices, nargs, type, action) of
    the parser that ``parse`` builds."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        seen["parser"] = self
        return orig(self, *a, **k)

    argparse.ArgumentParser.parse_args = grab
    try:
        parse(["x.mp4"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.type, type(a).__name__)
            for a in seen["parser"]._actions}


REF_TABLE = _table(inference_cli.parse_arguments)


def test_argument_table_has_the_same_options():
    assert sorted(_table(cli.parse_arguments)) == sorted(REF_TABLE)


@pytest.mark.parametrize("dest", sorted(REF_TABLE))
def test_argument_table_entry_equals_inference_cli(dest):
    assert _table(cli.parse_arguments)[dest] == REF_TABLE[dest]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_models")
    vc = config.vae_tiny()
    dc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    save_random_checkpoint(str(d / "tiny_dit.safetensors"), "dit", dc, torch.Generator().manual_seed(0), torch.float32)
    save_random_checkpoint(str(d / "tiny_vae.safetensors"), "vae", vc, torch.Generator().manual_seed(1), torch.float32)
    return d


def _argv(models, *extra):
    return ["--dit_model", "tiny_dit.safetensors", "--vae_model", "tiny_vae.safetensors", "--model_dir", str(models),
            "--resolution", "32", "--cuda_device", "cpu", *extra]


def _clip(path, n, h=20, w=24):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.stack([np.stack([xx / (w - 1), yy / (h - 1), np.full_like(xx, t / max(n - 1, 1))], -1)
                       for t in range(n)])
    wr = video.CV2Writer(str(path), w, h, 10.0)
    wr.write(frames)
    wr.close()
    return str(path)


class _Sink:
    """A video writer that keeps the frames it is handed (and leaves an
    empty file, which a resume manifest finds)."""

    def __init__(self, path, width, height, fps, kw):
        self.path, self.size, self.fps, self.kw, self.frames = path, (width, height), fps, kw, []

    def write(self, frames):
        self.frames.append(frames)

    def close(self):
        open(self.path, "wb").close()


def _sink(store):
    """A make_video_writer for either package's video module: each writer a
    _Sink, kept in ``store`` under its path."""

    def make(path, width, height, fps, backend="auto", **kw):
        store[path] = _Sink(path, width, height, fps, kw)
        return store[path]

    return make


@pytest.fixture
def recorder(monkeypatch):
    store = {}
    monkeypatch.setattr(video, "make_video_writer", _sink(store))
    return store


def _reference(models, frames, *extra):
    """phases.generate on ``frames`` with the runner the CLI builds for the
    same arguments."""
    args = cli.parse_arguments(["x.mp4", *_argv(models, *extra)])
    runner, cfg, _ = cli.build_runner(args)
    return phases.generate(runner, frames, cfg, packed=True)


def test_image_equals_phases_generate(models, tmp_path):
    img = np.random.RandomState(0).rand(20, 24, 3).astype(np.float32)
    video.write_image(str(tmp_path / "in.png"), img)
    assert cli.main([str(tmp_path / "in.png"), "--output", str(tmp_path / "out.png"), *_argv(models)]) == 0
    got = video.read_image(str(tmp_path / "out.png"))
    ref = _reference(models, video.read_image(str(tmp_path / "in.png"))[None])[0]
    assert got.shape == (32, 38, 3)
    np.testing.assert_array_equal(frameops.to_u8(got), frameops.to_u8(ref))


def test_rgba_image_keeps_an_upscaled_alpha(models, tmp_path):
    rgba = np.random.RandomState(1).rand(20, 24, 4).astype(np.float32)
    rgba[..., 3] = (np.mgrid[0:20, 0:24][1] > 11).astype(np.float32)
    video.write_image(str(tmp_path / "in.png"), rgba)
    assert cli.main([str(tmp_path / "in.png"), "--output", str(tmp_path / "out.png"), *_argv(models)]) == 0
    got = video.read_image(str(tmp_path / "out.png"))
    ref = _reference(models, video.read_image(str(tmp_path / "in.png"))[None])[0]
    assert got.shape == ref.shape == (32, 38, 4)
    np.testing.assert_array_equal(frameops.to_u8(got), frameops.to_u8(ref))
    assert got[:, :10, 3].mean() + 0.3 < got[:, -10:, 3].mean()  # the mask's two halves survive


def test_video_equals_phases_generate(models, tmp_path, recorder):
    src = _clip(tmp_path / "in.mp4", 7)
    extra = ("--input_noise_scale", "0.2", "--latent_noise_scale", "0.1", "--color_correction", "lab")
    assert cli.main([src, "--output", str(tmp_path / "out.mp4"), *_argv(models, *extra)]) == 0
    (w,) = recorder.values()
    got = np.concatenate(w.frames)
    ref = _reference(models, video.VideoReader(src, np.uint8).read(), *extra)
    assert got.shape == (7, 32, 38, 3) and got.dtype == ref.dtype == np.uint8  # no ffmpeg: the 8-bit sink, 8-bit codes
    np.testing.assert_array_equal(got, ref)
    assert w.kw["audio_source"] == src


def _inference_cli_loop(models, src, monkeypatch, *extra):
    """inference_cli.py's _process_video on ``src`` around the port's
    pipeline: the reference CLI's chunk loop and seam blend, each chunk
    through the port's process_frames (phases.generate). Returns the frames
    it hands its video writer."""
    pargs = cli.parse_arguments([src, *_argv(models, *extra)])
    runner, cfg, debug = cli.build_runner(pargs)
    monkeypatch.setattr(inference_cli, "process_frames",
                        lambda _r, _c, frames, _d, mesh=None, tile_debug="false":
                        cli.process_frames(runner, cfg, frames, debug, None, tile_debug))
    store = {}
    monkeypatch.setattr(jvideo, "make_video_writer", _sink(store))
    args = inference_cli.parse_arguments([src, *_argv(models, *extra)])
    inference_cli._process_video(args, None, None, None, None, src, src + ".ref.mp4")
    return np.concatenate(store[src + ".ref.mp4"].frames)


@pytest.mark.parametrize("n_in,chunk,ov,dtype", [
    pytest.param(12, 8, 2, np.float32, id="12"),
    pytest.param(14, 8, 2, np.float32, id="14"),
    pytest.param(12, 5, 3, np.float32, id="12-overlap3"),
    pytest.param(12, 8, 5, np.uint16, id="12-overlap5-codes"),
])
def test_chunked_overlap_frame_count_and_seams(models, tmp_path, recorder, monkeypatch, n_in, chunk, ov, dtype):
    """--chunk_size 8 --temporal_overlap 2 (the cases of
    tests/test_cli.py::test_cli_chunked_overlap_frame_count; 14: the last
    chunk would be exactly the carry), chunks of 5 overlapping by 3, whose
    middle seam frame is weighed 0.5 / 0.5, and an overlap of 5, which is
    the batch size: no overlap inside a chunk, so the fused path's 16-bit
    codes are blended and rounded back (weights 1, 1, 0.5, 0, 0); the
    smaller overlaps take the 4-phase path, whose frames are float. Each
    input frame is written once, the seams blended as inference_cli.py's
    loop blends them."""
    src = _clip(tmp_path / f"in{n_in}.mp4", n_in)
    extra = ("--color_correction", "none", "--chunk_size", str(chunk), "--temporal_overlap", str(ov),
             "--output_bits", "16")
    assert cli.main([src, "--output", str(tmp_path / "out.mp4"), *_argv(models, *extra)]) == 0
    (w,) = recorder.values()
    got = np.concatenate(w.frames)
    assert len(got) == n_in and got.dtype == dtype
    np.testing.assert_array_equal(got, _inference_cli_loop(models, src, monkeypatch, *extra))


def test_chunked_overlap_writes_every_frame_to_a_real_mp4(models, tmp_path):
    src = _clip(tmp_path / "in.mp4", 14)
    out = str(tmp_path / "out.mp4")
    assert cli.main([src, "--output", out, *_argv(models, "--chunk_size", "8", "--temporal_overlap", "2")]) == 0
    assert video.VideoReader(out).total_frames == 14


def test_skip_first_frames_load_cap_and_png_output(models, tmp_path):
    src = _clip(tmp_path / "in.mp4", 12)
    out = tmp_path / "seq.mp4"
    extra = ("--skip_first_frames", "2", "--load_cap", "6", "--output_format", "png", "--color_correction", "none")
    assert cli.main([src, "--output", str(out), *_argv(models, *extra)]) == 0
    names = sorted(os.listdir(tmp_path / "seq"))
    assert names == [f"frame_{i:06d}.png" for i in range(6)]
    ref = _reference(models, video.VideoReader(src, np.uint8).read()[2:8], "--color_correction", "none",
                     "--output_format", "png")
    got = np.stack([frameops.to_u8(video.read_image(str(tmp_path / "seq" / n))) for n in names])
    np.testing.assert_array_equal(got, frameops.to_u8(ref))


def test_mixed_directory(models, tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    _clip(d / "clip.mp4", 5)
    video.write_image(str(d / "still.png"), np.random.RandomState(2).rand(20, 24, 3).astype(np.float32))
    (d / "notes.txt").write_text("skipped")
    assert cli.main([str(d), *_argv(models)]) == 0
    out = tmp_path / "in_upscaled"
    assert sorted(os.listdir(out)) == ["clip.mp4", "still.png"]
    assert video.VideoReader(str(out / "clip.mp4")).total_frames == 5
    assert video.read_image(str(out / "still.png")).shape == (32, 38, 3)


def test_resume_runs_only_the_chunks_left(models, tmp_path, monkeypatch):
    """A chunked run records each chunk; after an interruption (here: the
    manifest of a run that finished two of three chunks) --resume runs the
    third alone and the parts hold every frame."""
    src = _clip(tmp_path / "in.mp4", 12)
    out = str(tmp_path / "out.mp4")
    argv = [src, "--output", out, *_argv(models, "--chunk_size", "5")]
    assert cli.main(argv) == 0
    manifest = out + ".resume.json"
    meta = json.load(open(manifest))
    assert meta["chunks_done"] == 3 and len(meta["segments"]) == 3  # no ffmpeg here: the parts stay
    meta["chunks_done"], meta["segments"] = 2, meta["segments"][:2]
    json.dump(meta, open(manifest, "w"))
    os.remove(tmp_path / "out.part0002.mp4")
    calls = []
    real = cli.process_frames
    monkeypatch.setattr(cli, "process_frames", lambda *a, **k: calls.append(len(a[2])) or real(*a, **k))
    assert cli.main(argv + ["--resume"]) == 0
    assert calls == [2]
    assert sum(video.VideoReader(str(tmp_path / f"out.part000{i}.mp4")).total_frames for i in range(3)) == 12


def test_tile_debug_draws_the_decode_grid(models, tmp_path, recorder):
    """--tile_debug decode draws the decode tiles on a video's frames; an
    image is written without the overlay, as inference_cli.py writes it."""
    from seedvr2_tpu_torch.utils.tile_debug import draw_for_config

    src = _clip(tmp_path / "in.mp4", 3, h=48, w=64)
    extra = ("--vae_decode_tiled", "--vae_decode_tile_size", "32", "--vae_decode_tile_overlap", "16")
    assert cli.main([src, "--output", str(tmp_path / "o.mp4"), "--tile_debug", "decode", *_argv(models, *extra)]) == 0
    args = cli.parse_arguments([src, *_argv(models, *extra)])
    runner, cfg, _ = cli.build_runner(args)
    plain = phases.generate(runner, video.VideoReader(src, np.uint8).read(), cfg)
    ref = draw_for_config(plain, cfg, "decode")
    got = np.concatenate(recorder[str(tmp_path / "o.mp4")].frames)
    np.testing.assert_array_equal(frameops.to_u8(got), frameops.to_u8(ref))
    assert np.abs(frameops.to_u8(ref).astype(int) - frameops.to_u8(plain).astype(int)).max() > 50
    video.write_image(str(tmp_path / "in.png"), np.random.RandomState(3).rand(48, 64, 3).astype(np.float32))
    for name, flags in (("a.png", ("--tile_debug", "decode")), ("b.png", ())):
        assert cli.main([str(tmp_path / "in.png"), "--output", str(tmp_path / name), *flags, *_argv(models, *extra)]) == 0
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def test_yuv420_sink_and_the_seam_blend(models, tmp_path, recorder, monkeypatch):
    """With an ffmpeg sink the fused path hands the writer the sink's planes;
    with chunk seams to blend the run stays on RGB codes (inference_cli.py
    sends planes into its float seam blend there and fails)."""
    monkeypatch.setattr(video, "have_ffmpeg", lambda: True)
    src = _clip(tmp_path / "in.mp4", 12)
    assert cli.main([src, "--output", str(tmp_path / "a.mp4"), *_argv(models)]) == 0
    w = recorder[str(tmp_path / "a.mp4")]
    assert all(is_planar(f) for f in w.frames) and w.kw == dict(planar_in=True, bit10=True, audio_source=src)
    assert sum(len(f) for f in w.frames) == 12 and w.frames[0].depth == 10
    # --chunk_size 8 with --temporal_overlap 5 (>= batch_size): in-chunk overlap 0 (the fused path), seams between chunks
    extra = ("--chunk_size", "8", "--temporal_overlap", "5", "--pixfmt", "yuv420")
    args = cli.parse_arguments([src, *_argv(models, *extra)])
    assert cli._resolve_pixfmt(args) == "rgb"
    assert cli.main([src, "--output", str(tmp_path / "b.mp4"), *_argv(models, *extra)]) == 0
    w = recorder[str(tmp_path / "b.mp4")]
    assert not any(is_planar(f) for f in w.frames) and sum(len(f) for f in w.frames) == 12
    assert w.frames[0].dtype == np.uint16
    assert cli._resolve_pixfmt(cli.parse_arguments([src, "--chunk_size", "5"])) == "yuv420"
    assert cli._resolve_pixfmt(cli.parse_arguments([src, "--output_format", "png"])) == "rgb"
    assert cli._resolve_pixfmt(cli.parse_arguments([src, "--video_backend", "opencv"])) == "rgb"


def test_run_reuses_a_runner_under_new_settings(models, tmp_path):
    """cli.run hands back its runner; a later run with other settings on the
    same model files reads no weights and equals a fresh run."""
    video.write_image(str(tmp_path / "in.png"), np.random.RandomState(4).rand(20, 24, 3).astype(np.float32))
    n, runner = cli.run([str(tmp_path / "in.png"), "--output", str(tmp_path / "a.png"), *_argv(models)])
    assert n == 1 and runner.cfg.color_correction == "wavelet"
    extra = ("--color_correction", "adain", "--latent_noise_scale", "0.3")
    _, again = cli.run([str(tmp_path / "in.png"), "--output", str(tmp_path / "b.png"), *_argv(models, *extra)], runner)
    assert again.dit is runner.dit and again.cfg.color_correction == "adain" and runner.cfg.color_correction == "wavelet"
    cli.main([str(tmp_path / "in.png"), "--output", str(tmp_path / "c.png"), *_argv(models, *extra)])
    assert (tmp_path / "b.png").read_bytes() == (tmp_path / "c.png").read_bytes()
    with pytest.raises(ValueError, match="fixed"):
        runner.with_config(runner.cfg.replace(compute_dtype="float32"))


@pytest.mark.parametrize(
    "flags,bits",
    [((), 16), (("--output_format", "png"), 16), (("--output_bits", "8"), 8), (("--10bit",), 16)],
)
def test_output_bits_without_ffmpeg_equal_inference_cli(monkeypatch, flags, bits):
    from seedvr2_tpu.io import video as jvideo

    monkeypatch.setattr(video, "have_ffmpeg", lambda: False)
    monkeypatch.setattr(jvideo, "have_ffmpeg", lambda: False)
    args = ["x.mp4", *flags]
    want = inference_cli._resolve_output_bits(inference_cli.parse_arguments(args))
    assert cli._resolve_output_bits(cli.parse_arguments(args)) == want == (8 if not flags else bits)


def test_unported_settings_raise_naming_the_roadmap(models, tmp_path, capsys, monkeypatch):
    """Nothing the CLI takes raises as unported any more: --quantize int8
    runs (tests/test_torch_gguf.py holds it against inference_cli.py), a
    .gguf --dit_model is read (a missing one is fetched from the hub, as
    inference_cli.py fetches it: here a fake hub answers 404, and the CLI
    raises the error JAX's downloader raises for it), and the flags
    without meaning here are noted and ignored."""
    video.write_image(str(tmp_path / "in.png"), np.zeros((8, 8, 3), np.float32))
    assert cli.main([str(tmp_path / "in.png"), "--output", str(tmp_path / "q.png"),
                     *_argv(models, "--quantize", "int8")]) == 0
    argv = _argv(models)
    argv[1] = "tiny_dit.gguf"
    hub = FakeHub({})
    monkeypatch.setattr(urllib.request, "urlopen", hub.urlopen)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    with pytest.raises(urllib.error.HTTPError, match="404") as got:
        cli.main([str(tmp_path / "in.png"), *argv])
    with pytest.raises(urllib.error.HTTPError) as ref:
        jregistry.download_model("tiny_dit.gguf", str(models))
    assert (got.value.code, got.value.url) == (ref.value.code, ref.value.url)
    assert hub.requests[:3] == hub.requests[3:] and len(hub.requests) == 6
    assert not os.path.exists(os.path.join(str(models), "tiny_dit.gguf"))
    assert cli.main([str(tmp_path / "in.png"), "--output", str(tmp_path / "o.png"), "--vae_conv_backend", "xla",
                     "--blocks_to_swap", "4", *_argv(models)]) == 0
    out = capsys.readouterr().out
    assert "--vae_conv_backend xla is ignored" in out and "--blocks_to_swap has no meaning here" in out


# --------------------------------------------------------------------------- #
# The CLI's own logic against inference_cli.py's on the same decoded clips
# --------------------------------------------------------------------------- #


def _stand_in(runner, cfg, frames, debug, mesh=None, tile_debug="false"):
    """process_frames in both CLIs: a fixed function of the clip it is
    handed, 16-bit codes at twice the size. Each frame's codes are offset by
    its place in the clip (4099 a place), so a frame that the next chunk runs
    again comes out different and a seam blend weighs two values."""
    f = np.asarray(frames)
    codes = f.astype(np.int64) * 257 if f.dtype == np.uint8 else np.round(f * 65535).astype(np.int64)
    codes = (codes + 4099 * np.arange(len(f)).reshape(-1, 1, 1, 1)) % 65536
    return np.repeat(np.repeat(codes.astype(np.uint16), 2, 1), 2, 2)


def _run_both(tmp_path, monkeypatch, capsys, runs):
    """``runs``: [(argv with "{out}" for the output root, before)], each
    run through inference_cli.main and through cli.main, with _stand_in for
    process_frames, no ffmpeg, no mesh and no weights; ``before(out)`` (or
    None) runs first on that CLI's output root. Returns, for "jax" and
    "torch": every file written ({path under the root: bytes}, the resume
    manifests read as JSON with the root written "<out>"), the frames each
    video writer was handed with its size, fps and options, and the lines
    that report frames and files."""
    which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda n, *a, **k: None if n in ("ffmpeg", "ffprobe") else which(n, *a, **k))
    monkeypatch.setattr(inference_cli, "build_mesh", lambda args, n_frames=None: None)
    monkeypatch.setattr(inference_cli, "build_runner", lambda args, mesh=None: (None, None, None))
    monkeypatch.setattr(cli, "build_runner", lambda args, mesh=None, runner=None: (None, cli.build_config(args), Debug()))
    monkeypatch.setattr(inference_cli, "process_frames", _stand_in)
    monkeypatch.setattr(cli, "process_frames", _stand_in)
    got = {}
    for name, main, vmod in (("jax", inference_cli.main, jvideo), ("torch", cli.main, video)):
        root = str(tmp_path / name)
        os.makedirs(root)
        store = {}
        monkeypatch.setattr(vmod, "make_video_writer", _sink(store))
        lines = []
        for argv, before in runs:
            if before is not None:
                before(root)
            capsys.readouterr()
            assert main([a.replace("{out}", root) for a in argv]) == 0
            for line in capsys.readouterr().out.splitlines():
                if line.startswith(("Saved", "Resuming", "Processed")):
                    lines.append(re.sub(r" in [0-9.]+s \(.*", "", line.replace(root, "<out>")))
        files = {}
        for d, _, names in os.walk(root):
            for f in names:
                path = os.path.join(d, f)
                rel = os.path.relpath(path, root)
                files[rel] = (json.loads(open(path).read().replace(root, "<out>")) if f.endswith(".json")
                              else open(path, "rb").read())
        sinks = {os.path.relpath(p, root): (np.concatenate(w.frames), w.size, w.fps, w.kw) for p, w in store.items()}
        got[name] = files, sinks, lines
    return got


def _assert_same(got):
    (files_j, sinks_j, lines_j), (files_t, sinks_t, lines_t) = got["jax"], got["torch"]
    assert lines_t == lines_j
    assert sorted(files_t) == sorted(files_j)
    for rel in files_j:
        assert files_t[rel] == files_j[rel], rel
    assert sorted(sinks_t) == sorted(sinks_j)
    for rel, (frames, size, fps, kw) in sinks_j.items():
        assert sinks_t[rel][1:] == (size, fps, kw), rel
        np.testing.assert_array_equal(sinks_t[rel][0], frames, err_msg=rel)


@pytest.mark.parametrize(
    "n_in,flags",
    [
        (12, ("--chunk_size", "8", "--temporal_overlap", "2")),
        (14, ("--chunk_size", "8", "--temporal_overlap", "2")),
        (12, ("--chunk_size", "5", "--temporal_overlap", "3")),
        (13, ("--chunk_size", "7", "--temporal_overlap", "6", "--fps", "12.5")),
        (12, ("--skip_first_frames", "2", "--load_cap", "6", "--output_format", "png")),
        (12, ("--skip_first_frames", "1", "--load_cap", "7", "--chunk_size", "3")),
        (12, ("--output_format", "png", "--chunk_size", "5", "--temporal_overlap", "3")),
        (9, ()),
    ],
    ids=["chunk8-overlap2", "chunk8-overlap2-carry", "chunk5-overlap3", "chunk7-overlap6-fps", "skip-cap-png",
         "skip-cap-chunk3-parts", "png-chunk5-overlap3", "whole"],
)
def test_video_loop_equals_inference_cli(tmp_path, monkeypatch, capsys, n_in, flags):
    """Chunks and their seam blends (overlap 3: weights 1, 0.5, 0; overlap
    6: 0.905 and 0.095 among them), --skip_first_frames, --load_cap,
    --fps, PNG sequences and chunk parts with their resume manifest: the
    same frames to the same files, the same counts and manifests."""
    src = _clip(tmp_path / "in.mp4", n_in)
    got = _run_both(tmp_path, monkeypatch, capsys, [([src, "--output", "{out}/out.mp4", *flags], None)])
    _assert_same(got)
    assert got["torch"][1] or got["torch"][0]  # something was written


def test_resume_equals_inference_cli(tmp_path, monkeypatch, capsys):
    """A chunked run, its manifest cut back to two of its three chunks (a
    run interrupted in the third), then --resume: the same chunks run
    again, the same parts, manifest and frame counts."""
    src = _clip(tmp_path / "in.mp4", 12)
    argv = [src, "--output", "{out}/out.mp4", "--chunk_size", "5"]

    def cut(root):
        path = os.path.join(root, "out.mp4.resume.json")
        meta = json.load(open(path))
        meta["chunks_done"], meta["segments"] = 2, meta["segments"][:2]
        json.dump(meta, open(path, "w"))

    got = _run_both(tmp_path, monkeypatch, capsys, [(argv, None), (argv + ["--resume"], cut)])
    _assert_same(got)
    files, sinks, lines = got["torch"]
    assert files["out.mp4.resume.json"]["chunks_done"] == 3 and "Resuming from chunk 2 (10 frames done)" in lines
    assert sorted(sinks) == ["out.part0000.mp4", "out.part0001.mp4", "out.part0002.mp4"]


def test_directory_and_images_equal_inference_cli(tmp_path, monkeypatch, capsys):
    """A directory of a video, an RGB and an RGBA image and a text file
    (chunks of 4 overlapping by 1), then a single image: the same files."""
    d = tmp_path / "in"
    d.mkdir()
    _clip(d / "clip.mp4", 9)
    rs = np.random.RandomState(5)
    video.write_image(str(d / "still.png"), rs.rand(20, 24, 3).astype(np.float32))
    video.write_image(str(d / "rgba.png"), rs.rand(20, 24, 4).astype(np.float32))
    (d / "notes.txt").write_text("skipped")
    runs = [([str(d), "--output", "{out}/dir", "--chunk_size", "4", "--temporal_overlap", "1"], None),
            ([str(d / "rgba.png"), "--output", "{out}/one.png"], None)]
    got = _run_both(tmp_path, monkeypatch, capsys, runs)
    _assert_same(got)
    assert sorted(got["torch"][0]) == ["dir/clip.mp4", "dir/rgba.png", "dir/still.png", "one.png"]
    assert sorted(got["torch"][1]) == ["dir/clip.mp4"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_mesh_on_two_gloo_ranks_equals_one_rank(models, tmp_path):
    """torchrun's environment for two ranks, each running
    ``python -m seedvr2_tpu_torch.cli ... --mesh 2,1,1 --cuda_device cpu``
    in a fresh interpreter without jax: a 3-frame clip is under 2 frames a
    rank, so both ranks run the clip with the tiled VAE's tiles split
    between them; rank 0 writes the PNGs, equal to one rank's run."""
    src = _clip(tmp_path / "in.mp4", 3, h=40, w=48)
    extra = ("--output_format", "png", "--vae_encode_tiled", "--vae_encode_tile_size", "32",
             "--vae_encode_tile_overlap", "16", "--vae_decode_tiled", "--vae_decode_tile_size", "32",
             "--vae_decode_tile_overlap", "16")
    assert cli.main([src, "--output", str(tmp_path / "one.mp4"), *_argv(models, *extra)]) == 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "seedvr2_tpu_torch.cli", src, "--output", str(tmp_path / "two.mp4"), "--mesh", "2,1,1",
           *_argv(models, *extra)]
    procs = [subprocess.Popen(cmd, cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), [o[1][-3000:] for o in outs]
    assert "mesh: data=2 seq=1 tensor=1" in outs[0][0] and "Processed 3 frames" in outs[0][0]
    assert "Saved" not in outs[1][0]  # rank 1 writes nothing
    one, two = sorted(os.listdir(tmp_path / "one")), sorted(os.listdir(tmp_path / "two"))
    assert one == two and len(one) == 3
    for n in one:
        a = video.read_image(str(tmp_path / "one" / n))
        b = video.read_image(str(tmp_path / "two" / n))
        assert np.abs(frameops.to_u8(a).astype(int) - frameops.to_u8(b).astype(int)).max() <= 1
