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
registers.

K7's layout: ``w_q`` is stored [N, K] (each output column's K weights
contiguous, the transpose of the JAX package's [K, N]); models/params.py
converts it once at load. ``w_s`` and ``b`` keep their JAX shapes ([N], or
[3, inner] for qkv) and are read flat.
"""

from __future__ import annotations

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
    cuda_lib.require(N % 64 == 0 and K % 64 == 0, f"linear_apply: N={N}, K={K} (K7 needs both % 64)")


def linear_apply(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] -> [..., N] = (x @ widen(w_q)) * w_s (+ b), w_q stored [N,
    K] int8 (K7's layout), w_s fp32 [N] (any shape of N elements), b in x's
    type or None (a row-parallel layer adds its bias after the sum over its
    tensor group). On the card K7 computes the product in fp32, applies the
    scale and the bias in fp32 and rounds once to bf16."""
    if x.device.type == "cpu":
        return linear_apply_plain(x, w_q, w_s, b)
    N, K = w_q.shape
    cuda_lib.require(x.shape[-1] == K, f"linear_apply: x has {x.shape[-1]} features, the weight {K}")
    check_shape(N, K)
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    cuda_lib.require(0 < M <= 128 * cuda_lib.MAX_GRID_YZ, f"linear_apply: M={M}")
    cuda_lib.require_cuda_tensor(x2, "x", torch.bfloat16)
    cuda_lib.require_cuda_tensor(w_q, "w_q", torch.int8, (N, K))
    cuda_lib.require(w_s.numel() == N, f"linear_apply: w_s has {w_s.numel()} elements, N={N}")
    ws = w_s.reshape(-1)
    cuda_lib.require_cuda_tensor(ws, "w_s", torch.float32)
    bias = None if b is None else b.reshape(-1)
    if bias is not None:
        cuda_lib.require(bias.numel() == N, f"linear_apply: b has {bias.numel()} elements, N={N}")
        cuda_lib.require_cuda_tensor(bias, "b", torch.bfloat16)
    cuda_lib.require(all(t.device == x.device for t in (w_q, ws) + ((bias,) if bias is not None else ())),
                     "linear_apply: tensors on different devices")
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        code = lib.seedvr2_w8a16_linear(
            x2.data_ptr(), w_q.data_ptr(), ws.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
            M, N, K, cuda_lib.stream_ptr(x),
        )
    cuda_lib.check(code, "linear_apply")
    linear_apply.launches += 1
    return y.reshape(*x.shape[:-1], N)


linear_apply.launches = 0
