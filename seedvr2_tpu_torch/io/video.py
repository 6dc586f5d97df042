"""Host video and image I/O (counterpart of seedvr2_tpu/io/video.py): input
kinds, PNG read and write, the cv2 and ffmpeg readers and writers, their
factories and the PNG-sequence sink. Decode and encode run on the host;
the card sees uint8 / 16-bit codes, floats, or yuv420 planes.

Three faults of the JAX package's I/O are not copied here:
- planar (yuv420) reads are only live when the probe reports BT.601
  limited range, or no colour tags at all: ops/yuv.py converts with that
  matrix and range only, so a BT.709 or full-range source takes the RGB
  path (``planar_colorimetry_ok``);
- ``FFmpegWriter.write`` rejects RGB frames sent to a writer built for
  planes (they would be piped as planes and corrupt the file);
- ``FFmpegReader(dtype=float32, planar=True)`` reads [0, 1] RGB floats:
  planes are raw codes, so planar reads are live for the packed dtype only.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
from typing import Iterator, Optional

import numpy as np

from ..ops.yuv import PlanarYUV420, is_planar, yuv420_to_rgb01_np
from . import frameops

VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v", ".flv", ".wmv", ".gif"}
IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".tif", ".webp"}
# ffprobe's color_space names of the BT.601 matrix (625- and 525-line)
BT601_SPACES = ("bt470bg", "smpte170m")


def input_type(path: str) -> str:
    """'video' | 'image' | 'directory'."""
    if os.path.isdir(path):
        return "directory"
    ext = os.path.splitext(path)[1].lower()
    if ext in VIDEO_EXTS:
        return "video"
    if ext in IMAGE_EXTS:
        return "image"
    raise ValueError(f"Unsupported input: {path}")


def read_image(path: str) -> np.ndarray:
    """[H, W, 3|4] float32 in [0, 1], RGB(A)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    if img.dtype == np.uint8:
        return frameops.u8_to_f32_rgb(img, swap_rb=True)
    img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4 else cv2.COLOR_BGR2RGB)
    return img.astype(np.float32) / (65535.0 if img.dtype == np.uint16 else 255.0)


def write_image(path: str, frame01: np.ndarray) -> None:
    """frame01: [H, W, 3|4] float32 in [0, 1], uint8 or uint16 codes; written
    as an 8-bit image."""
    import cv2

    img = frameops.to_u8(frame01)
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGBA2BGRA if img.shape[2] == 4 else cv2.COLOR_RGB2BGR))


def _concat_t(a, b):
    if is_planar(a):
        return PlanarYUV420(*(np.concatenate([p, q], axis=0) for p, q in ((a.y, b.y), (a.u, b.u), (a.v, b.v))),
                            depth=a.depth)
    return np.concatenate([a, b], axis=0)


def _copy_t(a):
    return a.tmap(np.copy) if is_planar(a) else a.copy()


def _chunks(reader, chunk_size: int, overlap: int = 0) -> Iterator:
    """Chunks of ``chunk_size`` frames, each after the first starting with
    the last ``overlap`` frames of the one before (the reference CLI's
    streaming generator). A chunk that would hold only the carried frames
    is not yielded."""
    carry = None
    while True:
        need = chunk_size - (len(carry) if carry is not None else 0)
        fresh = reader.read(need)
        if carry is not None and len(carry) > 0:
            chunk = _concat_t(carry, fresh) if len(fresh) else carry
        else:
            chunk = fresh
        if len(chunk) == 0:
            return
        if carry is not None and len(fresh) == 0:
            return
        yield chunk
        if len(fresh) < need:
            return
        carry = _copy_t(chunk[-overlap:]) if overlap > 0 else None


class VideoReader:
    """cv2 video reader: [T, H, W, 3] RGB frames, float32 in [0, 1], or the
    decoder's uint8 bytes with ``dtype=np.uint8`` (scaled on the card)."""

    def __init__(self, path: str, dtype=np.float32):
        import cv2

        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(path)
        self.dtype = np.dtype(dtype)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.total_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def seek(self, frame_idx: int) -> None:
        import cv2

        self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)

    def read(self, n: Optional[int] = None) -> np.ndarray:
        u8 = self.dtype == np.uint8
        frames = []
        while n is None or len(frames) < n:
            ok, frame = self.cap.read()
            if not ok:
                break
            frames.append(frame[..., ::-1] if u8 else frameops.u8_to_f32_rgb(frame, swap_rb=True))
        if not frames:
            return np.zeros((0, self.height, self.width, 3), self.dtype)
        return np.stack(frames)

    def chunks(self, chunk_size: int, overlap: int = 0):
        return _chunks(self, chunk_size, overlap)

    def close(self):
        self.cap.release()


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def have_ffprobe() -> bool:
    return shutil.which("ffprobe") is not None


def _parse_ffprobe_stream(stream: dict) -> dict:
    """One ffprobe video stream: size, fps, frame count, the bit depth
    parsed from pix_fmt (yuv420p10le -> 10) and the colour tags ("unknown"
    where the stream has none)."""
    num, _, den = (stream.get("r_frame_rate") or "30/1").partition("/")
    fps = float(num) / float(den or 1) if float(den or 1) else 30.0
    nb = stream.get("nb_frames")
    if nb in (None, "N/A"):
        nb = stream.get("nb_read_packets")
    pix = stream.get("pix_fmt") or "yuv420p"
    m = re.search(r"(\d+)(le|be)$", pix)
    return {
        "width": int(stream["width"]),
        "height": int(stream["height"]),
        "fps": fps,
        "total_frames": int(nb) if nb not in (None, "N/A") else 0,
        "bits": int(m.group(1)) if m else 8,
        "pix_fmt": pix,
        "color_range": stream.get("color_range") or "unknown",
        "color_space": stream.get("color_space") or "unknown",
    }


def _ffprobe(path: str) -> dict:
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0", "-count_packets", "-show_entries",
         "stream=width,height,r_frame_rate,nb_frames,nb_read_packets,pix_fmt,color_range,color_space",
         "-of", "json", path],
        capture_output=True, check=True,
    )
    streams = json.loads(out.stdout)["streams"]
    if not streams:
        raise ValueError(f"no video stream in {path}")
    return _parse_ffprobe_stream(streams[0])


def planar_colorimetry_ok(meta: dict) -> bool:
    """The source's planes are what ops/yuv.py converts: BT.601 limited
    range as the probe reports it, or no range or matrix tag (untagged
    streams are taken as BT.601 limited, as swscale does)."""
    return meta["color_range"] in ("tv", "unknown") and meta["color_space"] in ("unknown", *BT601_SPACES)


class FFmpegReader:
    """ffmpeg-subprocess video reader. >8-bit sources decode losslessly to
    uint16 (rgb48le), feeding the 16-bit device path.

    ``dtype=np.uint8`` means the packed decoder output: uint8 for 8-bit
    sources, uint16 for deeper ones. ``planar=True`` asks for the codec's
    yuv420 planes (PlanarYUV420, converted on the card): live only for a
    packed read of a yuv420p 8- or 10-bit source of even size whose probe
    passes ``planar_colorimetry_ok``; ``self.planar`` says which mode is
    live. A float read always returns [0, 1] RGB."""

    def __init__(self, path: str, dtype=np.float32, planar: bool = False):
        self.path = path
        meta = _ffprobe(path)
        self.width, self.height = meta["width"], meta["height"]
        self.fps = meta["fps"] or 30.0
        self.total_frames = meta["total_frames"]
        self.bits = meta["bits"]
        self._u16 = self.bits > 8
        self._packed = np.dtype(dtype) == np.uint8
        self.planar = bool(
            planar
            and self._packed
            and meta["pix_fmt"].startswith("yuv420p")
            and self.bits in (8, 10)
            and self.width % 2 == 0
            and self.height % 2 == 0
            and planar_colorimetry_ok(meta)
        )
        self.dtype = np.dtype(np.uint16 if self._u16 else np.uint8) if self._packed else np.dtype(dtype)
        self._start = 0
        self.proc: Optional[subprocess.Popen] = None

    def _spawn(self):
        if self.planar:
            pix = "yuv420p10le" if self._u16 else "yuv420p"
        else:
            pix = "rgb48le" if self._u16 else "rgb24"
        cmd = ["ffmpeg", "-loglevel", "error", "-i", self.path]
        if self._start:
            # frame-exact seek: drop the first N decoded frames
            cmd += ["-vf", f"select=gte(n\\,{self._start})", "-fps_mode", "passthrough"]
        cmd += ["-f", "rawvideo", "-pix_fmt", pix, "-"]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)

    def seek(self, frame_idx: int) -> None:
        self._start = int(frame_idx)
        self.close()

    def read(self, n: Optional[int] = None):
        if self.proc is None:
            self._spawn()
        raw = np.uint16 if self._u16 else np.uint8
        if self.planar:
            return self._read_planar(n, raw)
        frame_bytes = self.width * self.height * 3 * np.dtype(raw).itemsize
        frames = []
        while n is None or len(frames) < n:
            buf = self.proc.stdout.read(frame_bytes)
            if buf is None or len(buf) < frame_bytes:
                break
            frames.append(np.frombuffer(buf, raw).reshape(self.height, self.width, 3))
        if not frames:
            return np.zeros((0, self.height, self.width, 3), self.dtype)
        out = np.stack(frames)
        if self._packed:
            return out
        return out.astype(np.float32) / (65535.0 if self._u16 else 255.0)

    def _read_planar(self, n: Optional[int], raw) -> PlanarYUV420:
        h, w = self.height, self.width
        isz = np.dtype(raw).itemsize
        ybytes, cbytes = h * w * isz, (h // 2) * (w // 2) * isz
        ys, us, vs = [], [], []
        while n is None or len(ys) < n:
            buf = self.proc.stdout.read(ybytes + 2 * cbytes)
            if buf is None or len(buf) < ybytes + 2 * cbytes:
                break
            ys.append(np.frombuffer(buf, raw, h * w).reshape(h, w))
            us.append(np.frombuffer(buf, raw, (h // 2) * (w // 2), ybytes).reshape(h // 2, w // 2))
            vs.append(np.frombuffer(buf, raw, (h // 2) * (w // 2), ybytes + cbytes).reshape(h // 2, w // 2))
        if not ys:
            zc = np.zeros((0, h // 2, w // 2), raw)
            return PlanarYUV420(np.zeros((0, h, w), raw), zc, zc, self.bits)
        return PlanarYUV420(np.stack(ys), np.stack(us), np.stack(vs), self.bits)

    def chunks(self, chunk_size: int, overlap: int = 0):
        return _chunks(self, chunk_size, overlap)

    def close(self):
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait()
            self.proc = None


def make_video_reader(path: str, dtype=np.float32, backend: str = "auto", planar: bool = False):
    """Reader for ``--video_backend``: 'opencv' -> cv2; 'ffmpeg' ->
    FFmpegReader (raises without ffmpeg and ffprobe); 'auto' -> ffmpeg
    where it gives more than cv2 (a >8-bit source, or planar reads that
    would be live), else cv2."""
    if backend in ("opencv", "cv2"):
        return VideoReader(path, dtype)
    if backend == "ffmpeg":
        if not (have_ffmpeg() and have_ffprobe()):
            raise RuntimeError("--video_backend ffmpeg requires ffmpeg+ffprobe in PATH")
        return FFmpegReader(path, dtype, planar=planar)
    if have_ffmpeg() and have_ffprobe():
        try:
            reader = FFmpegReader(path, dtype, planar=planar)
        except (subprocess.CalledProcessError, ValueError, KeyError):  # a file ffprobe cannot read: try cv2
            reader = None
        if reader is not None and (reader.bits > 8 or reader.planar):
            return reader
    return VideoReader(path, dtype)


class FFmpegWriter:
    """x265 encode through an ffmpeg subprocess: 10-bit (yuv420p10le) by
    default. ``planar_in=True``: frames arrive as PlanarYUV420 of depth 10
    (``bit10``) or 8 and are piped raw; RGB frames are then refused."""

    def __init__(self, path: str, width: int, height: int, fps: float, codec: str = "libx265", crf: int = 16,
                 bit10: bool = True, audio_source: Optional[str] = None, planar_in: bool = False):
        if planar_in:
            pix_in = "yuv420p10le" if bit10 else "yuv420p"
        else:
            pix_in = "rgb48le" if bit10 else "rgb24"
        self.bit10 = bit10
        self.planar_in = planar_in
        cmd = ["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo", "-pix_fmt", pix_in,
               "-s", f"{width}x{height}", "-r", f"{fps}", "-i", "-"]
        if audio_source:
            cmd += ["-i", audio_source, "-map", "0:v", "-map", "1:a?", "-c:a", "copy"]
        cmd += ["-c:v", codec, "-crf", str(crf), "-pix_fmt", "yuv420p10le" if bit10 else "yuv420p", path]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)

    def write(self, frames01) -> None:
        """[T, H, W, 3] float in [0, 1], uint8 or uint16 codes; with
        planar_in a PlanarYUV420 of the writer's depth."""
        if is_planar(frames01):
            if not self.planar_in:
                raise ValueError("writer was not constructed with planar_in")
            if frames01.depth != (10 if self.bit10 else 8):
                raise ValueError(f"{frames01.depth}-bit planes sent to a {10 if self.bit10 else 8}-bit planar writer")
            data = frames01.tobytes()
        elif self.planar_in:
            raise ValueError("RGB frames sent to a writer constructed with planar_in: they would be piped as planes")
        else:
            data = (frameops.to_u16(frames01) if self.bit10 else frameops.to_u8(frames01)).tobytes()
        try:
            self.proc.stdin.write(data)
        except BrokenPipeError as e:
            raise RuntimeError("ffmpeg pipe closed (encode error)") from e

    def close(self) -> None:
        if self.proc.stdin:
            self.proc.stdin.close()
        ret = self.proc.wait()
        if ret != 0:
            raise RuntimeError(f"ffmpeg exited with {ret}")


class CV2Writer:
    """8-bit mp4 through cv2, where ffmpeg is absent."""

    def __init__(self, path: str, width: int, height: int, fps: float, **_kw):
        import cv2

        self.writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))

    def write(self, frames01) -> None:
        import cv2

        if is_planar(frames01):  # converted on the host
            frames01 = yuv420_to_rgb01_np(frames01.to_numpy())
        for f in frames01:
            self.writer.write(cv2.cvtColor(frameops.to_u8(f), cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        self.writer.release()


def make_video_writer(path: str, width: int, height: int, fps: float, backend: str = "auto", **kw):
    """10-bit x265 through ffmpeg where it is present, else 8-bit cv2 mp4;
    'opencv' forces cv2, 'ffmpeg' requires ffmpeg."""
    if backend in ("opencv", "cv2"):
        return CV2Writer(path, width, height, fps)
    if backend == "ffmpeg" and not have_ffmpeg():
        raise RuntimeError("--video_backend ffmpeg requires ffmpeg in PATH")
    if have_ffmpeg():
        return FFmpegWriter(path, width, height, fps, **kw)
    return CV2Writer(path, width, height, fps)


def write_png_sequence(directory: str, frames01, start_index: int = 0, prefix: str = "frame") -> None:
    """One PNG a frame, ``<prefix>_<index:06d>.png``; planes are converted
    on the host."""
    if is_planar(frames01):
        frames01 = yuv420_to_rgb01_np(frames01.to_numpy())
    os.makedirs(directory, exist_ok=True)
    for i, f in enumerate(frames01):
        write_image(os.path.join(directory, f"{prefix}_{start_index + i:06d}.png"), f)
