"""K10: the VAE's mid attention, one head over every pixel of a frame.

softmax(q k^T / sqrt(C)) v for each frame of q, k, v [F, n, C]. On a CUDA
tensor it launches the hand-written kernel (csrc/mid_attention.cuh: bf16
wgmma with fp32 accumulators, an online fp32 softmax, every frame in one
launch, no n x n tensor anywhere); on a CPU tensor it runs the plain
version, the math of the JAX package's _mid_attention
(seedvr2_tpu/models/vae/model.py:168) in its order: fp32 logits of the
bf16 q and k, an fp32 softmax, the probabilities cast to v's dtype before
P V. There is no other route: a CUDA tensor the kernel does not take
raises. The launch counter: ``mid_attention.launches``.
"""

from __future__ import annotations

import torch

from . import cuda_lib

WIDTHS = (256, 512)  # the kernel's C: the released VAE's mid block, and the small one of the card checks


def mid_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[F, n, C] -> [F, n, C] in v's dtype, a frame at a time: fp32 logits
    q k^T / sqrt(C), an fp32 softmax, the probabilities in v's dtype
    times v."""
    C = q.shape[-1]
    out = torch.empty_like(v)
    for i in range(q.shape[0]):
        logits = (q[i].float() @ k[i].float().T) * (1.0 / C**0.5)
        out[i] = torch.softmax(logits, dim=-1).to(v.dtype) @ v[i]
    return out


def mid_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [F, n, C] -> [F, n, C]. On a CUDA tensor the kernel runs; its
    contract: bf16, contiguous, 16-byte aligned, all three of one shape on
    one device, C in WIDTHS. Anything else raises. On a CPU tensor:
    mid_attention_plain."""
    if q.device.type == "cpu":
        return mid_attention_plain(q, k, v)
    cuda_lib.require(q.dim() == 3, f"mid_attention: q of shape {tuple(q.shape)}")
    F, n, C = q.shape
    cuda_lib.require(C in WIDTHS and F >= 1 and n >= 1, f"mid_attention: q of shape {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.require_cuda_tensor(t, name, torch.bfloat16, (F, n, C), device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = cuda_lib.library().seedvr2_mid_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), F, n, C, 1.0 / C**0.5,
            cuda_lib.stream_ptr(q),
        )
    cuda_lib.check(code, "mid_attention")
    mid_attention.launches += 1
    return out


mid_attention.launches = 0


def kernel_attributes(C: int) -> dict:
    """K10's kernel at width C as the CUDA runtime holds it: registers a
    thread, local memory (spills) a thread, and the dynamic shared memory it
    launches with."""
    return cuda_lib.attributes("seedvr2_mid_attention_attributes", C)
