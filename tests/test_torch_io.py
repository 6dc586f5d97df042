"""The port's host I/O vs the JAX package's: frame conversions (native and
numpy routes), the resume manifest, PNG and cv2 video round trips, the
chunk generator, the tile overlay, the checkpoint export and the run log;
and three faults of the JAX package's ffmpeg I/O that the port does not
copy, shown with fake probes and pipes (no ffmpeg needed).

Every comparison is exact: this is host code on the same bytes.
"""

import io
import json
import os
import subprocess

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu import config as jconfig
from seedvr2_tpu.io import frameops as jframeops
from seedvr2_tpu.io import resume as jresume
from seedvr2_tpu.io import video as jvideo
from seedvr2_tpu.io import weights as jweights
from seedvr2_tpu.utils import tile_debug as jtile_debug
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io import checkpoint, frameops, resume, video
from seedvr2_tpu_torch.ops.yuv import PlanarYUV420, rgb01_to_yuv420_np
from seedvr2_tpu_torch.utils import debug, tile_debug

# --------------------------------------------------------------------------- #
# Frame conversions
# --------------------------------------------------------------------------- #


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(frameops, "_build", lambda: None)
        monkeypatch.setattr(jframeops, "_build", lambda: None)
    else:
        assert frameops.available() and jframeops.available()
    return request.param


def test_frame_conversions_equal_jax(route):
    rs = np.random.RandomState(0)
    for shape in ((16, 20, 3), (8, 6, 4)):
        u8 = rs.randint(0, 256, shape).astype(np.uint8)
        for swap in (True, False):
            got, ref = frameops.u8_to_f32_rgb(u8, swap_rb=swap), jframeops.u8_to_f32_rgb(u8, swap_rb=swap)
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
    x = rs.rand(1 << 16).astype(np.float32) * 1.2 - 0.1  # out-of-range values clamp
    np.testing.assert_array_equal(frameops.f32_to_u16(x), jframeops.f32_to_u16(x))
    np.testing.assert_array_equal(frameops.f32_to_u8(x), jframeops.f32_to_u8(x))
    for arr in (x, (x.clip(0, 1) * 65535).astype(np.uint16), (x.clip(0, 1) * 255).astype(np.uint8)):
        np.testing.assert_array_equal(frameops.to_u16(arr), jframeops.to_u16(arr))
        np.testing.assert_array_equal(frameops.to_u8(arr), jframeops.to_u8(arr))
    y = rs.randn(4, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(frameops.denorm_clamp_(y.copy()), jframeops.denorm_clamp_(y.copy()))
    np.testing.assert_array_equal(frameops.denorm_clamp_(y[:, ::2]), jframeops.denorm_clamp_(y[:, ::2]))


def test_native_library_builds_under_build(route):
    if route == "native":
        assert frameops.available()
        assert any(p.name == "libframeops.so" for p in frameops.BUILD_ROOT.rglob("*.so"))


# --------------------------------------------------------------------------- #
# The resume manifest
# --------------------------------------------------------------------------- #


def test_resume_manifest_equals_jax(tmp_path):
    inp = tmp_path / "in.mp4"
    inp.write_bytes(b"x")
    outs = {}
    for name, mod in (("port", resume), ("jax", jresume)):
        out = str(tmp_path / f"{name}.mp4")
        m = mod.ResumeManifest(out, str(inp), total_frames=12, chunk_size=5)
        for ci in range(2):
            seg = m.segment_path(ci)
            open(seg, "wb").write(b"seg")
            m.mark_done(ci, seg)
        assert (m.chunks_done, m.frames_done) == (2, 10)
        outs[name] = json.load(open(out + ".resume.json"))
        assert m.segment_path(3).endswith(f"{name}.part0003.mp4")
    port, ref = outs["port"], outs["jax"]
    assert port.keys() == ref.keys() and {k: v for k, v in port.items() if k != "segments"} == {
        k: v for k, v in ref.items() if k != "segments"}
    # each package resumes from the other's manifest; another chunk size or input does not match
    out = str(tmp_path / "jax.mp4")
    m = resume.ResumeManifest.load_if_matching(out, str(inp), 12, 5)
    assert m is not None and m.chunks_done == 2 and m.meta == ref
    assert jresume.ResumeManifest.load_if_matching(str(tmp_path / "port.mp4"), str(inp), 12, 5).meta == port
    assert resume.ResumeManifest.load_if_matching(out, str(inp), 12, 4) is None
    open(out + ".resume.json", "w").write("{not json")
    assert resume.ResumeManifest.load_if_matching(out, str(inp), 12, 5) is None


def test_resume_finalize_without_ffmpeg_keeps_the_parts(tmp_path, monkeypatch):
    monkeypatch.setattr("shutil.which", lambda name: None)
    inp = tmp_path / "in.mp4"
    inp.write_bytes(b"x")
    m = resume.ResumeManifest(str(tmp_path / "o.mp4"), str(inp), 10, 5)
    for ci in range(2):
        open(m.segment_path(ci), "wb").write(b"s")
        m.mark_done(ci, m.segment_path(ci))
    assert m.finalize() == m.segment_path(0)
    one = resume.ResumeManifest(str(tmp_path / "p.mp4"), str(inp), 5, 5)
    open(one.segment_path(0), "wb").write(b"s")
    one.mark_done(0, one.segment_path(0))
    assert one.finalize() == str(tmp_path / "p.mp4") and not os.path.exists(one.path)


# --------------------------------------------------------------------------- #
# Images, cv2 video, chunks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["rgb", "rgba", "rgb16"])
def test_png_round_trip_equals_jax(tmp_path, kind):
    import cv2

    rs = np.random.RandomState(1)
    if kind == "rgb16":  # a 16-bit PNG written by cv2, read by both packages
        codes = rs.randint(0, 65536, (9, 11, 3)).astype(np.uint16)
        cv2.imwrite(str(tmp_path / "a.png"), codes)
    else:
        frame = rs.rand(9, 11, 4 if kind == "rgba" else 3).astype(np.float32)
        video.write_image(str(tmp_path / "a.png"), frame)
        jvideo.write_image(str(tmp_path / "b.png"), frame)
        assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    got, ref = video.read_image(str(tmp_path / "a.png")), jvideo.read_image(str(tmp_path / "a.png"))
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert video.input_type(str(tmp_path / "a.png")) == "image" and video.input_type(str(tmp_path)) == "directory"
    with pytest.raises(FileNotFoundError):
        video.read_image(str(tmp_path / "missing.png"))


def _write_clip(path, n):
    """Smooth frames, a little different each: what a lossy codec keeps."""
    yy, xx = np.mgrid[0:20, 0:24].astype(np.float32)
    frames = np.stack([np.stack([xx / 23.0, yy / 19.0, np.full_like(xx, t / max(n - 1, 1))], -1) for t in range(n)])
    w = video.make_video_writer(path, 24, 20, 10.0, backend="opencv")
    w.write(frames)
    w.close()
    return frames


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_cv2_video_round_trip_equals_jax(tmp_path, dtype):
    path = str(tmp_path / "a.mp4")
    frames = _write_clip(path, 7)
    r, jr = video.VideoReader(path, dtype), jvideo.VideoReader(path, dtype)
    assert (r.total_frames, r.width, r.height, r.fps) == (jr.total_frames, jr.width, jr.height, jr.fps) == (7, 24, 20, 10.0)
    got, ref = r.read(), jr.read()
    assert got.dtype == ref.dtype == dtype and got.shape == (7, 20, 24, 3)
    np.testing.assert_array_equal(got, ref)
    f01 = got.astype(np.float32) / (255.0 if dtype == np.uint8 else 1.0)
    assert np.abs(f01 - frames).mean() < 0.1  # mp4v is lossy; the content survives
    r.seek(5)
    jr.seek(5)
    np.testing.assert_array_equal(r.read(), jr.read())
    r.close()
    jr.close()


@pytest.mark.parametrize("n,chunk,overlap", [(12, 8, 2), (14, 8, 2), (12, 5, 0), (11, 5, 1)])
def test_chunks_equal_jax(tmp_path, n, chunk, overlap):
    """14 frames in chunks of 8 overlapping by 2: the last chunk would be
    exactly the carry and is not yielded."""
    path = str(tmp_path / "a.mp4")
    _write_clip(path, n)
    got = list(video.VideoReader(path, np.uint8).chunks(chunk, overlap))
    ref = list(jvideo.VideoReader(path, np.uint8).chunks(chunk, overlap))
    assert [len(c) for c in got] == [len(c) for c in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_png_sequence_and_planar_sinks(tmp_path):
    frames = np.random.RandomState(3).rand(3, 8, 10, 3).astype(np.float32)
    video.write_png_sequence(str(tmp_path / "seq"), frames, start_index=5)
    jvideo.write_png_sequence(str(tmp_path / "jseq"), frames, start_index=5)
    names = sorted(os.listdir(tmp_path / "seq"))
    assert names == sorted(os.listdir(tmp_path / "jseq")) == [f"frame_00000{i}.png" for i in (5, 6, 7)]
    for n in names:
        assert (tmp_path / "seq" / n).read_bytes() == (tmp_path / "jseq" / n).read_bytes()
    planes = rgb01_to_yuv420_np(frames, 8)  # a planar result reaching a PNG or cv2 sink is converted on the host
    video.write_png_sequence(str(tmp_path / "pseq"), planes)
    assert len(os.listdir(tmp_path / "pseq")) == 3
    w = video.CV2Writer(str(tmp_path / "p.mp4"), 10, 8, 5.0)
    w.write(planes)
    w.close()
    assert video.VideoReader(str(tmp_path / "p.mp4")).total_frames == 3


# --------------------------------------------------------------------------- #
# ffmpeg: the faults not copied (fake probes and pipes)
# --------------------------------------------------------------------------- #


def _meta(**tags):
    stream = {"width": 8, "height": 6, "r_frame_rate": "25/1", "nb_frames": "3", "pix_fmt": "yuv420p", **tags}
    return video._parse_ffprobe_stream(stream)


class _FakeProc:
    """A Popen stand-in: stdout serves ``data``, stdin collects what is written."""

    def __init__(self, cmd, data=b""):
        self.cmd = cmd
        self.stdout = io.BytesIO(data)
        self.stdin = io.BytesIO()
        self.stdin.close = lambda: None
        self.returncode = 0

    def wait(self):
        return 0

    def kill(self):
        pass


@pytest.mark.parametrize(
    "tags,live",
    [({}, True), ({"color_range": "tv", "color_space": "bt470bg"}, True), ({"color_space": "smpte170m"}, True),
     ({"color_range": "tv", "color_space": "bt709"}, False), ({"color_range": "pc"}, False),
     ({"color_range": "pc", "color_space": "bt470bg"}, False), ({"color_space": "bt2020nc"}, False)],
)
def test_planar_reads_only_for_bt601_limited_sources(monkeypatch, tags, live):
    """The JAX reader goes planar for any yuv420p source; its planes are
    then converted as BT.601 limited range, wrong for BT.709 or full range.
    The port reads planes only where the probe says BT.601 limited range
    or carries no colour tags; otherwise it reads RGB from ffmpeg."""
    monkeypatch.setattr(video, "_ffprobe", lambda path: _meta(**tags))
    r = video.FFmpegReader("x.mp4", np.uint8, planar=True)
    assert r.planar is live
    monkeypatch.setattr(jvideo, "_ffprobe", lambda path: jvideo._parse_ffprobe_stream(
        {"width": 8, "height": 6, "r_frame_rate": "25/1", "nb_frames": "3", "pix_fmt": "yuv420p", **tags}))
    assert jvideo.FFmpegReader("x.mp4", np.uint8, planar=True).planar  # the fault: planar whatever the tags
    rgb = np.random.RandomState(4).randint(0, 256, (3, 6, 8, 3)).astype(np.uint8)
    planes = rgb01_to_yuv420_np(rgb.astype(np.float32) / 255.0, 8)
    seen = []

    def popen(cmd, **kw):
        seen.append(cmd)
        return _FakeProc(cmd, planes.tobytes() if "yuv420p" in cmd else rgb.tobytes())

    monkeypatch.setattr(subprocess, "Popen", popen)
    out = r.read()
    assert seen[0][seen[0].index("-pix_fmt") + 1] == ("yuv420p" if live else "rgb24")
    if live:
        assert isinstance(out, PlanarYUV420) and out.depth == 8
        np.testing.assert_array_equal(out.y, planes.y)
    else:
        np.testing.assert_array_equal(out, rgb)


def test_planar_writer_rejects_rgb_frames(monkeypatch):
    """The JAX writer pipes RGB frames sent to a planar writer as if they
    were planes (a silently corrupt file); the port's raises."""
    procs = []
    monkeypatch.setattr(subprocess, "Popen", lambda cmd, **kw: procs.append(_FakeProc(cmd)) or procs[-1])
    w = video.FFmpegWriter("o.mp4", 8, 6, 25.0, bit10=False, planar_in=True)
    planes = rgb01_to_yuv420_np(np.random.RandomState(5).rand(2, 6, 8, 3).astype(np.float32), 8)
    w.write(planes)
    assert procs[0].stdin.getvalue() == planes.tobytes()
    with pytest.raises(ValueError, match="RGB frames"):
        w.write(np.zeros((2, 6, 8, 3), np.uint16))
    with pytest.raises(ValueError, match="10-bit planes"):
        w.write(rgb01_to_yuv420_np(np.zeros((1, 6, 8, 3), np.float32), 10))
    assert procs[0].stdin.getvalue() == planes.tobytes()  # nothing else reached the pipe
    jw = jvideo.FFmpegWriter("o.mp4", 8, 6, 25.0, bit10=False, planar_in=True)
    jw.write(np.zeros((2, 6, 8, 3), np.float32))  # the fault: accepted and piped
    assert len(procs[1].stdin.getvalue()) == 2 * 6 * 8 * 3
    rgb_writer = video.FFmpegWriter("o.mp4", 8, 6, 25.0, bit10=True)
    frames = np.random.RandomState(6).rand(2, 6, 8, 3).astype(np.float32)
    rgb_writer.write(frames)
    assert procs[2].stdin.getvalue() == frameops.to_u16(frames).tobytes()
    assert "rgb48le" in procs[2].cmd and "yuv420p10le" in procs[2].cmd
    with pytest.raises(ValueError, match="planar_in"):
        rgb_writer.write(planes)


def test_float_reader_never_returns_raw_planes(monkeypatch):
    """The JAX reader built with dtype=float32 and planar=True returns the
    raw codes as planes; the port's reads [0, 1] RGB floats."""
    monkeypatch.setattr(video, "_ffprobe", lambda path: _meta())
    rgb = np.random.RandomState(7).randint(0, 256, (3, 6, 8, 3)).astype(np.uint8)
    cmds = []
    monkeypatch.setattr(subprocess, "Popen", lambda cmd, **kw: cmds.append(cmd) or _FakeProc(cmd, rgb.tobytes()))
    r = video.FFmpegReader("x.mp4", np.float32, planar=True)
    assert not r.planar and r.dtype == np.float32
    out = r.read(2)
    assert out.dtype == np.float32 and out.shape == (2, 6, 8, 3) and 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_array_equal(out, rgb[:2].astype(np.float32) / 255.0)
    assert "rgb24" in cmds[0]
    monkeypatch.setattr(jvideo, "_ffprobe", lambda path: jvideo._parse_ffprobe_stream(
        {"width": 8, "height": 6, "r_frame_rate": "25/1", "nb_frames": "3", "pix_fmt": "yuv420p"}))
    assert jvideo.FFmpegReader("x.mp4", np.float32, planar=True).planar  # the fault


def test_ffprobe_parsing_equals_jax_and_reads_colour_tags():
    s = {"width": 640, "height": 360, "r_frame_rate": "30000/1001", "nb_frames": "N/A", "nb_read_packets": "145",
         "pix_fmt": "yuv420p10le", "color_range": "tv", "color_space": "bt709"}
    got, ref = video._parse_ffprobe_stream(s), jvideo._parse_ffprobe_stream(s)
    assert {k: got[k] for k in ref} == ref
    assert (got["color_range"], got["color_space"]) == ("tv", "bt709")
    assert video._parse_ffprobe_stream({"width": 2, "height": 2})["color_space"] == "unknown"


def test_ffmpeg_round_trip(tmp_path):
    """With ffmpeg present: a 10-bit planar write read back as planes, and
    the readers' frame counts."""
    if not (video.have_ffmpeg() and video.have_ffprobe()):
        pytest.skip("ffmpeg/ffprobe not in PATH")
    rgb = np.random.RandomState(8).rand(4, 32, 48, 3).astype(np.float32)
    planes = rgb01_to_yuv420_np(rgb, 10)
    w = video.make_video_writer(str(tmp_path / "a.mp4"), 48, 32, 10.0, planar_in=True, bit10=True)
    w.write(planes)
    w.close()
    r = video.make_video_reader(str(tmp_path / "a.mp4"), np.uint8, planar=True)
    assert r.planar and r.bits == 10
    back = r.read()
    r.close()
    assert back.depth == 10 and len(back) == 4
    assert np.abs(back.y.astype(np.int64) - planes.y.astype(np.int64)).mean() < 8


# --------------------------------------------------------------------------- #
# The tile overlay, the checkpoint export, the run log
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("hw", [(64, 96), (720, 1280), (1088, 1920), (40, 40)])
@pytest.mark.parametrize("tile,overlap", [((32, 32), (16, 16)), ((512, 512), (0, 0)), ((1024, 1024), (128, 128))])
def test_tile_boundaries_equal_jax(hw, tile, overlap):
    assert tile_debug.tile_boundaries(*hw, tile, overlap) == jtile_debug.tile_boundaries(*hw, tile, overlap)


def test_tile_overlay_equals_jax():
    frames = np.random.RandomState(9).rand(2, 64, 96, 4).astype(np.float32)
    for which in ("encode", "decode"):
        cfg = config.PipelineConfig(decode_tiled=True, encode_tiled=True, decode_tile_size=(32, 48),
                                    decode_tile_overlap=(16, 16), encode_tile_size=(48, 48), encode_tile_overlap=(8, 8))
        jcfg = jconfig.PipelineConfig(decode_tiled=True, encode_tiled=True, decode_tile_size=(32, 48),
                                      decode_tile_overlap=(16, 16), encode_tile_size=(48, 48), encode_tile_overlap=(8, 8))
        got, ref = tile_debug.draw_for_config(frames, cfg, which), jtile_debug.draw_for_config(frames, jcfg, which)
        np.testing.assert_array_equal(got, ref)
        assert np.abs(got - frames).max() > 0.1
    assert tile_debug.draw_for_config(frames, config.PipelineConfig(), "decode") is frames


@pytest.mark.parametrize("which", ["dit", "vae"])
def test_export_state_dict_equals_jax(which):
    """The inverse of convert_state_dict, key by key and value for value,
    for a tiny DiT and VAE tree; and back through convert_state_dict."""
    import jax

    from seedvr2_tpu.models.dit.nadit import init_params
    from seedvr2_tpu.models.vae.model import init_vae_params

    if which == "dit":
        cfg, pcfg = jconfig.dit_tiny(), config.dit_tiny()
        tree, key_map = init_params(cfg, jax.random.PRNGKey(0)), checkpoint.dit_key_map(pcfg)
        jmap = jweights.dit_key_map(cfg)
    else:
        cfg, pcfg = jconfig.vae_tiny(), config.vae_tiny()
        tree, key_map = init_vae_params(cfg, jax.random.PRNGKey(1)), checkpoint.vae_key_map(pcfg)
        jmap = jweights.vae_key_map(cfg)
    tree = jax.tree.map(np.asarray, tree)
    ref = jweights.export_state_dict(tree, jmap)
    got = checkpoint.export_state_dict(tree, key_map)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k])
    flat = checkpoint.flatten_tree(tree)
    back = checkpoint.convert_state_dict(got, key_map, dtype=None)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    as_torch = checkpoint.export_state_dict({k: torch.from_numpy(np.array(v)) for k, v in flat.items()}, key_map)
    for k in ref:
        np.testing.assert_array_equal(as_torch[k].numpy(), ref[k])


def test_random_checkpoint_loads_as_the_random_modules(tmp_path):
    """save_random_checkpoint writes random_dit's / random_vae's draws in
    the reference layout: load_runner reads them back to the same weights."""
    import dataclasses

    from seedvr2_tpu_torch.io.weights import random_dit, random_vae, save_random_checkpoint
    from seedvr2_tpu_torch.pipeline.loader import load_runner

    vc = config.vae_tiny()
    dc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    save_random_checkpoint(str(tmp_path / "tiny_dit.safetensors"), "dit", dc, torch.Generator().manual_seed(3),
                           torch.float32)
    save_random_checkpoint(str(tmp_path / "tiny_vae.safetensors"), "vae", vc, torch.Generator().manual_seed(4),
                           torch.float32)
    cfg = config.PipelineConfig(dit=dc, vae=vc, compute_dtype="float32")
    runner = load_runner("tiny_dit.safetensors", "tiny_vae.safetensors", str(tmp_path), cfg, device="cpu")
    for loaded, made in ((runner.dit, random_dit(dc, torch.Generator().manual_seed(3), torch.float32)),
                         (runner.vae, random_vae(vc, torch.Generator().manual_seed(4), torch.float32))):
        a, b = dict(loaded.named_buffers()), dict(made.named_buffers())
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert runner.text_neg is not None and runner.text_neg.shape[-1] == dc.txt_in_dim


def test_debug_timers_and_reports(capsys):
    d = debug.Debug(enabled=True, device="cpu")
    d.start_timer("outer")
    with d.timer("inner"):
        pass
    assert d.end_timer("outer", "outer done", show_breakdown=True) >= 0.0
    assert d.end_timer("never started") == 0.0
    d.environment_report("sageattn_2")
    d.log_memory_state("x")
    d.peak_memory_summary()
    out = capsys.readouterr().out
    assert "outer done" in out and "  ⏱️ inner" in out and "Attention mode: sageattn_2" in out
    assert "Native frameops: available" in out and "torch:" in out and "Host RSS" in out
    assert d.peak_memory_gib() is None  # no device memory on a CPU run
    debug.Debug().log("quiet")
    debug.Debug().log("loud", force=True)
    assert capsys.readouterr().out.strip().endswith("loud")
