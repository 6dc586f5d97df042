"""Build and load the hand-written CUDA kernels of ``seedvr2_tpu_torch/csrc``.

The kernels are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface (``csrc/kernels.cu``) and bound with
``ctypes``. The library is built at first use into
``build/kernels/<hash of the sources and flags>/`` at the repository root, so
a checkout builds everything it runs from its own sources, and a changed
source never loads a stale library.

Nothing here runs at import: the CPU tests import every module of the port
on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libseedvr2_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class Build:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, including -Xptxas -v register/smem report


_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_SIGNATURES = {
    "seedvr2_conv3d_3x3x3": [_vp] * 4 + [_i] * 6 + [_vp],
    "seedvr2_fold_upsample": [_vp] * 5 + [_i] * 7 + [_vp],
    "seedvr2_window_attention": [_vp] * 10 + [_i] * 8 + [_f] * 2 + [_vp],
    "seedvr2_flash_attention": [_vp] * 6 + [_i] * 4 + [_f] + [_vp],
}

_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Build:
    """Compile csrc/kernels.cu (which includes the .cuh kernels) unless the
    library for these exact sources already exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Build(lib, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "kernels.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return Build(lib, seconds, log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.seedvr2_error_string.argtypes = [ctypes.c_int]
        lib.seedvr2_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().seedvr2_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, what: str) -> None:
    """Reject an argument the kernel does not take (raises, never falls back)."""
    if not cond:
        raise ValueError(what)


MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z


def require_cuda_tensor(t, name: str, dtype, shape=None) -> None:
    require(t.is_cuda, f"{name}: expected a CUDA tensor, got {t.device}")
    require(t.dtype == dtype, f"{name}: expected {dtype}, got {t.dtype}")
    require(t.is_contiguous(), f"{name}: expected a contiguous tensor")
    require(t.data_ptr() % 16 == 0, f"{name}: expected 16-byte alignment")
    if shape is not None:
        require(tuple(t.shape) == tuple(shape), f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
