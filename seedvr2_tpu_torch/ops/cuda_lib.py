"""Build and load the hand-written CUDA kernels of ``seedvr2_tpu_torch/csrc``.

Each ``csrc/*.cu`` file (one kernel's plain C entry points, including its
``.cuh``) is compiled by its own ``nvcc`` process for Hopper (``sm_90a``),
all of them started together; the objects are linked into one shared
library, bound with ``ctypes``. The library is built at first use into
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
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libseedvr2_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH, "-shared")


@dataclass
class Build:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, including -Xptxas -v register/smem report
    compile_seconds: tuple  # each source's nvcc wall time; their sum is a one-after-another build


_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_SIGNATURES = {
    "seedvr2_conv3d_3x3x3": [_vp] * 6 + [_i] * 6 + [_vp],
    "seedvr2_conv3d_im2col": [_vp] * 4 + [_i] * 6 + [_vp],
    "seedvr2_conv3d_attributes": [_i] + [ctypes.POINTER(_i)] * 3,
    "seedvr2_fold_upsample": [_vp] * 5 + [_i] * 7 + [_vp],
    "seedvr2_fold_upsample_attributes": [ctypes.POINTER(_i)] * 3,
    "seedvr2_window_qk_prepare": [_vp] * 18 + [_i] * 8 + [_f] + [_vp],
    "seedvr2_window_flash": [_vp] * 14 + [_i] * 6 + [_f] + [_vp],
    "seedvr2_window_flash_attributes": [_i] + [ctypes.POINTER(_i)] * 3,
    "seedvr2_window_prepare": [_vp] * 9 + [_i] * 8 + [_f] + [_vp],
    "seedvr2_flash_attention": [_vp] * 6 + [_i] * 4 + [_f] + [_vp],
    "seedvr2_flash_attention_attributes": [ctypes.POINTER(_i)] * 3,
    "seedvr2_mid_attention": [_vp] * 4 + [_i] * 3 + [_f] + [_vp],
    "seedvr2_mid_attention_attributes": [_i] + [ctypes.POINTER(_i)] * 3,
    "seedvr2_gn_stats": [_vp] * 6 + [_i] * 7 + [_f] + [_vp],
    "seedvr2_gn_apply": [_vp] * 4 + [_i] * 6 + [_vp],
    "seedvr2_w8a16_linear": [_vp] * 5 + [_i] * 3 + [_vp],
    "seedvr2_w8a16_linear_splitk": [_vp] * 6 + [_i] * 4 + [_vp],
    "seedvr2_w8a16_splitk_splits": [_i, _i, ctypes.POINTER(_i)],
}

_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
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


def _run(cmd) -> tuple:
    """One nvcc call: its return code, wall seconds, and command line with output."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, time.perf_counter() - t0, f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"


def build() -> Build:
    """Compile every csrc/*.cu in parallel (one nvcc each) and link them,
    unless the library for these exact sources already exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Build(lib, 0.0, log, ())
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [str(out_dir / f"{src.stem}.{pid}.o") for src in srcs]
    with ThreadPoolExecutor(len(srcs)) as pool:  # waits for every compile, so none outlives a failure
        results = list(pool.map(_run, [[nvcc, *COMPILE_FLAGS, "-o", o, str(s)] for o, s in zip(objs, srcs)]))
    log = "\n".join(out for _, _, out in results)
    if any(rc != 0 for rc, _, _ in results):
        raise RuntimeError("nvcc failed:\n" + log)
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    rc, _, out = _run([nvcc, *LINK_FLAGS, "-o", str(tmp), *objs])
    log += "\n" + out
    if rc != 0:
        raise RuntimeError(f"nvcc link failed ({rc}):\n{log}")
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return Build(lib, seconds, log, tuple(sec for _, sec, _ in results))


def ptxas_lines(log: str, kernel: str = "") -> list:
    """(kernel, line) for ptxas's register and spill lines in a build log
    (nvcc runs with -Xptxas -v), for the kernels whose mangled name
    contains ``kernel``."""
    out, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif kernel in name and ("registers" in line or "spill" in line):
            out.append((name, line.replace("ptxas info    :", "").strip()))
    return out


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


# + CUresult: a failed cuTensorMapEncodeTiled (conv_pipeline.cuh, w8a16_linear.cu, window_attention.cuh,
# flash_attention.cuh, mid_attention.cuh)
ENCODE_ERROR = 1 << 20


def check(code: int, what: str) -> None:
    if code >= ENCODE_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with CUresult {code - ENCODE_ERROR}")
    if code != 0:
        msg = library().seedvr2_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def attributes(entry: str, *args) -> dict:
    """A kernel as the CUDA runtime holds it, from its C entry ``entry``
    (``args``, then three int pointers): registers a thread, local memory
    (spills) a thread, and the dynamic shared memory it launches with."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = getattr(library(), entry)(*args, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(smem))
    check(code, entry)
    return {"registers": regs.value, "local_bytes": local.value, "smem_bytes": smem.value}


def stream_ptr(t) -> int:
    """The current CUDA stream of t's device, as the integer a C entry
    takes (PyTorch's raw-stream query: no Stream object is made)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require(cond: bool, what: str) -> None:
    """Reject an argument the kernel does not take (raises, never falls back)."""
    if not cond:
        raise ValueError(what)


MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
MAX_GRID_X = 2**31 - 1  # and on gridDim.x


def require_cuda_tensor(t, name: str, dtype, shape=None, device=None) -> None:
    """Reject a tensor a kernel does not take: off the card (or off
    ``device``), of another dtype, strided, unaligned or (where given) of
    another shape. Each message is built only when its check fails."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, the other tensors on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte alignment")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
