"""Weight-only int8 storage of the DiT's block linears, and K7, the W8A16
linear that runs them (counterpart of seedvr2_tpu/ops/quant.py).

A quantized linear keeps its weight as int8 with one fp32 scale per output
column, absmax over the contraction axis / 127. The scale is per output
column, so ``(x @ w_q) * w_s == x @ (w_q * w_s)``: the product runs on the
int8 weight widened to the input's type and the scale is applied to the
result. In the JAX package XLA fuses the int8 -> bf16 widening into the
product, so no dequantized copy of the weight ever exists; eager PyTorch
would write one on every call, so on the card the product is K7
(csrc/w8a16_linear.cuh), which reads the int8 weight and widens it in
registers, in the regime of the row count (``regime``): wgmma for the
video rows, split-K with a fixed-order reduce for the text rows.

K7's layout: ``w_q`` is stored [N, K] (each output column's K weights
contiguous, the transpose of the JAX package's [K, N]); models/params.py
converts it once at load. ``w_s`` and ``b`` keep their JAX shapes ([N], or
[3, inner] for qkv) and are read flat.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from . import cuda_lib

_QUANT_MIN_SIZE = 1 << 16  # only matrices are quantized; vectors stay dense


def quantize_weight(w) -> Dict[str, torch.Tensor]:
    """w: [..., dout] (contraction axes leading; numpy array or tensor, on
    any device) -> {"w_q": int8 [..., dout], "w_s": fp32 [dout]}: absmax
    over the contraction axes / 127, round half to even, clipped to ±127,
    the scale floored at 1e-12 in the division. Bit-equal to the JAX
    package's numpy version."""
    wf = torch.as_tensor(np.asarray(w) if not isinstance(w, torch.Tensor) else w).float()
    absmax = wf.abs().amax(dim=tuple(range(wf.ndim - 1)), keepdim=True)
    scale = absmax / 127.0
    q = torch.round(wf / scale.clamp_min(1e-12)).clamp_(-127, 127).to(torch.int8)
    return {"w_q": q, "w_s": scale.reshape(-1)}


def quantize_linear(w) -> Dict[str, torch.Tensor]:
    """A block linear's weight [D, *out] (a qkv weight is [D, 3, inner]) ->
    w_q [D, *out] and w_s [*out]: the contraction axis is the first one
    only, as the JAX package's _quantize_tree reshapes qkv."""
    w = torch.as_tensor(np.asarray(w) if not isinstance(w, torch.Tensor) else w)
    q = quantize_weight(w.reshape(w.shape[0], -1))
    return {"w_q": q["w_q"].reshape(w.shape), "w_s": q["w_s"].reshape(w.shape[1:])}


def is_quantized(p) -> bool:
    """A linear's leaves (a dict, or a Leaf's spec) hold an int8 weight."""
    return "w_q" in p


def dequantize_weight(p: Mapping, dtype=torch.bfloat16) -> torch.Tensor:
    """w_q [D, *out] (the JAX layout) * w_s [*out] in fp32, then ``dtype``."""
    return (p["w_q"].float() * p["w_s"].float()).to(dtype)


def quantizes(path: str, shape, min_size: Optional[int] = None) -> bool:
    """The JAX package's rule: a block linear's ``w`` of ndim >= 2 and at
    least ``min_size`` elements (_QUANT_MIN_SIZE) is stored as int8."""
    min_size = _QUANT_MIN_SIZE if min_size is None else min_size
    return path.startswith("blocks/") and path.endswith("/w") and len(shape) >= 2 and int(np.prod(shape)) >= min_size


def quantize_dit_params(flat: Mapping[str, object], min_size: Optional[int] = None) -> Dict[str, object]:
    """A flat JAX-path DiT dict -> the same with every ``w`` that
    ``quantizes`` replaced by ``w_q`` (int8) and ``w_s`` (fp32) tensors;
    patch in/out and the embeddings stay dense, as in the JAX package. Leaf
    by leaf, so a dense weight can be dropped as soon as it is quantized."""
    out = {}
    for path, arr in flat.items():
        if quantizes(path, tuple(arr.shape), min_size):
            stem = path[: -len("w")]
            q = quantize_linear(arr)
            out[stem + "w_q"], out[stem + "w_s"] = q["w_q"], q["w_s"]
        else:
            out[path] = arr
    return out


def tree_bytes(params) -> int:
    """Bytes of a flat dict's arrays, or of a module's buffers."""
    leaves = params.buffers() if hasattr(params, "buffers") else params.values()
    return sum(int(np.prod(t.shape)) * (t.element_size() if hasattr(t, "element_size") else t.itemsize)
               for t in leaves)


# --------------------------------------------------------------------------- #
# K7: the W8A16 linear
# --------------------------------------------------------------------------- #


def linear_apply_plain(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's order: the product on the widened weight in x's
    type, then the scale, then the bias, each in x's type."""
    y = x @ w_q.t().to(x.dtype).contiguous()  # [K, N] as the dense path's weight, so its sums run in that order
    y = y * w_s.reshape(-1).to(x.dtype)
    return y if b is None else y + b.reshape(-1).to(x.dtype)


def check_shape(N: int, K: int) -> None:
    """K7 takes N and K multiples of 64: every int8 linear of NaDiT-3B and
    7B, whole or split over a tensor axis of 2 or 4 (3B's MLP at tensor=4:
    N = 6912 / 4 = 1728)."""
    if N % 64 or K % 64:
        raise ValueError(f"linear_apply: N={N}, K={K} (K7 needs both % 64)")


TEXT_ROWS = 64  # K7 takes M <= TEXT_ROWS by split-K (csrc/w8a16_linear.cuh: kTextRows)


def regime(M: int) -> str:
    """K7's regime for M rows: "splitk" (the text rows, bound by the
    weight's bytes) or "wgmma" (the video rows, bound by operations)."""
    return "splitk" if M <= TEXT_ROWS else "wgmma"


@functools.lru_cache(maxsize=None)
def splits(lib, index: int, N: int, K: int) -> int:
    """The split-K regime's K splits for a weight [N, K] on card ``index``,
    from ``lib``'s own tile sizes and SM count
    (csrc/w8a16_linear.cu: seedvr2_w8a16_splitk_splits)."""
    s = ctypes.c_int()
    with torch.cuda.device(index):
        cuda_lib.check(lib.seedvr2_w8a16_splitk_splits(N, K, ctypes.byref(s)), "linear_apply")
    return s.value


def launch(lib, x2: torch.Tensor, w_q: torch.Tensor, ws: torch.Tensor, bias: Optional[torch.Tensor],
           y: torch.Tensor) -> str:
    """Run K7 from ``lib`` on checked CUDA tensors (x2 [M, K], w_q [N, K],
    ws [N], bias [N] or None, y [M, N]) in the regime of M; the split-K
    workspace [splits, M, N] fp32 comes from torch.empty. Returns the
    regime."""
    (M, K), N = x2.shape, w_q.shape[0]
    dev = x2.device
    stream = cuda_lib.stream_ptr(x2)
    b = None if bias is None else bias.data_ptr()
    kind = regime(M)
    with contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev):
        if kind == "splitk":
            s = splits(lib, dev.index, N, K)
            part = torch.empty((s, M, N), dtype=torch.float32, device=dev)
            code = lib.seedvr2_w8a16_linear_splitk(x2.data_ptr(), w_q.data_ptr(), ws.data_ptr(), b, y.data_ptr(),
                                                   part.data_ptr(), M, N, K, s, stream)
        else:
            code = lib.seedvr2_w8a16_linear(x2.data_ptr(), w_q.data_ptr(), ws.data_ptr(), b, y.data_ptr(), M, N, K,
                                            stream)
    cuda_lib.check(code, "linear_apply")
    return kind


def linear_apply(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] -> [..., N] = (x @ widen(w_q)) * w_s (+ b), w_q stored [N,
    K] int8 (K7's layout), w_s fp32 [N] (any shape of N elements), b in x's
    type or None (a row-parallel layer adds its bias after the sum over its
    tensor group). On the card K7 computes the product in fp32, applies the
    scale and the bias in fp32 and rounds once to bf16, in the regime of
    its row count (``regime``). Counts: ``launches``, ``launches_wgmma``,
    ``launches_splitk`` and ``launches_by_shape[(M, K, N)]``."""
    if x.device.type == "cpu":
        return linear_apply_plain(x, w_q, w_s, b)
    N, K = w_q.shape
    if x.shape[-1] != K:
        raise ValueError(f"linear_apply: x has {x.shape[-1]} features, the weight {K}")
    check_shape(N, K)
    x2 = x if x.dim() == 2 else x.reshape(-1, K)
    M = x2.shape[0]
    if not 0 < M <= cuda_lib.MAX_GRID_X:  # the C entries take M as an int
        raise ValueError(f"linear_apply: M={M}")
    ws = w_s if w_s.dim() == 1 else w_s.reshape(-1)
    if ws.numel() != N:
        raise ValueError(f"linear_apply: w_s has {ws.numel()} elements, N={N}")
    bias = b if b is None or b.dim() == 1 else b.reshape(-1)
    if bias is not None and bias.numel() != N:
        raise ValueError(f"linear_apply: b has {bias.numel()} elements, N={N}")
    dev = x.device
    cuda_lib.require_cuda_tensor(x2, "x", torch.bfloat16)
    cuda_lib.require_cuda_tensor(w_q, "w_q", torch.int8, device=dev)
    cuda_lib.require_cuda_tensor(ws, "w_s", torch.float32, device=dev)
    if bias is not None:
        cuda_lib.require_cuda_tensor(bias, "b", torch.bfloat16, device=dev)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    kind = launch(cuda_lib.library(), x2, w_q, ws, bias, y)
    linear_apply.launches += 1
    if kind == "splitk":
        linear_apply.launches_splitk += 1
    else:
        linear_apply.launches_wgmma += 1
    shapes = linear_apply.launches_by_shape
    shapes[(M, K, N)] = shapes.get((M, K, N), 0) + 1
    return y if x.dim() == 2 else y.reshape(*x.shape[:-1], N)


def reset_launches() -> None:
    """Every K7 count to 0 (the per-shape counts emptied)."""
    linear_apply.launches = linear_apply.launches_wgmma = linear_apply.launches_splitk = 0
    linear_apply.launches_by_shape = {}


reset_launches()
