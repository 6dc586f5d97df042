"""Host frame conversions of the video I/O path: ctypes bindings of
``seedvr2_tpu_torch/native/frameops.cpp``, with numpy forms used when the
library cannot be built (counterpart of seedvr2_tpu/io/frameops.py).

The library is compiled with ``g++`` at first use into
``build/frameops/<hash of the source and flags>/`` at the repository root,
so a changed source never loads a stale library; it is built without
``-march=native`` (a build directory may travel to another machine) and
with ``-ffp-contract=off``, so that the float -> code loops round as the
numpy forms do. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "frameops.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "frameops"
FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None where g++ or the build
    fails (the numpy forms then run)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        tag = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
        so = BUILD_ROOT / tag / "libframeops.so"
        try:
            if not so.exists():
                so.parent.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)  # each build writes its own file
                os.close(fd)
                try:
                    subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp], check=True, capture_output=True)
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError):
            return None
        size, vp, i = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int
        lib.u8_to_f32_rgb.argtypes = [vp, vp, size, i, i]
        lib.f32_to_u16.argtypes = [vp, vp, size]
        lib.f32_to_u8.argtypes = [vp, vp, size]
        lib.denorm_clamp.argtypes = [vp, size]
        for fn in (lib.u8_to_f32_rgb, lib.f32_to_u16, lib.f32_to_u8, lib.denorm_clamp):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _build() is not None


def u8_to_f32_rgb(frame_u8: np.ndarray, swap_rb: bool = True) -> np.ndarray:
    """[H, W, 3|4] uint8 (BGR(A) when swap_rb) -> float32 RGB(A) in [0, 1]."""
    lib = _build()
    frame_u8 = np.ascontiguousarray(frame_u8, np.uint8)
    nch = frame_u8.shape[-1]
    if nch not in (3, 4):
        raise ValueError(f"u8_to_f32_rgb takes 3 or 4 channels, got {nch}")
    if lib is None:
        out = frame_u8.astype(np.float32) / 255.0
        if swap_rb:
            out[..., [0, 2]] = out[..., [2, 0]]
        return out
    out = np.empty(frame_u8.shape, np.float32)
    lib.u8_to_f32_rgb(frame_u8.ctypes.data, out.ctypes.data, frame_u8.size // nch, nch, int(swap_rb))
    return out


def f32_to_u16(frames01: np.ndarray) -> np.ndarray:
    lib = _build()
    frames01 = np.ascontiguousarray(frames01, np.float32)
    if lib is None:
        return (np.clip(frames01, 0, 1) * 65535.0 + 0.5).astype("<u2")
    out = np.empty(frames01.shape, "<u2")
    lib.f32_to_u16(frames01.ctypes.data, out.ctypes.data, frames01.size)
    return out


def f32_to_u8(frames01: np.ndarray) -> np.ndarray:
    lib = _build()
    frames01 = np.ascontiguousarray(frames01, np.float32)
    if lib is None:
        return (np.clip(frames01, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    out = np.empty(frames01.shape, np.uint8)
    lib.f32_to_u8(frames01.ctypes.data, out.ctypes.data, frames01.size)
    return out


def to_u16(frames: np.ndarray) -> np.ndarray:
    """Any output dtype -> uint16 codes: float32 in [0, 1] is converted,
    uint8 scaled by 257, uint16 (packed output) passes through."""
    if frames.dtype == np.uint16:
        return frames
    if frames.dtype == np.uint8:
        return frames.astype(np.uint16) * np.uint16(257)  # 255 * 257 == 65535
    return f32_to_u16(frames)


def to_u8(frames: np.ndarray) -> np.ndarray:
    """Any output dtype -> uint8 codes (see to_u16); uint16 rounds v / 257."""
    if frames.dtype == np.uint8:
        return frames
    if frames.dtype == np.uint16:
        return ((frames.astype(np.uint32) + 128) // 257).astype(np.uint8)
    return f32_to_u8(frames)


def denorm_clamp_(x: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1] and clamp, in place where the array allows."""
    lib = _build()
    if lib is None or not (x.flags.c_contiguous and x.dtype == np.float32):
        return np.clip(x * 0.5 + 0.5, 0.0, 1.0).astype(np.float32)
    lib.denorm_clamp(x.ctypes.data, x.size)
    return x
