"""Attention modes and the unfused attention call (counterpart of
seedvr2_tpu/ops/attention.py).

The user-facing ``attention_mode`` names of the CLI and the nodes resolve to
one of four backends with the JAX package's alias table:

- "fused": the DiT's window attention runs K3 (ops/fused_window_attention.py);
- "fused_int8": K3 with per-token int8 q/k logits, K3q (``sageattn_2/3``);
- "pallas": the DiT's window attention is unfused and calls K5
  (ops/flash_attention.py) (``flash_attn_2/3``);
- "xla": unfused, with the plain einsum + fp32 softmax below (``sdpa``).

The JAX package keeps the backend in a module global; here it is explicit:
``NaDiT(..., attention_mode=...)`` holds the resolved backend and passes it
down. Generic ``attention`` calls map fused* onto the plain path, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention

ATTENTION_ALIASES = {
    "sdpa": "xla",
    "xla": "xla",
    "flash_attn_2": "pallas",
    "flash_attn_3": "pallas",
    "sageattn_2": "fused_int8",
    "sageattn_3": "fused_int8",
    "fused_int8": "fused_int8",
    "pallas": "pallas",
    "fused": "fused",
}


def resolve_attention_mode(name: str) -> str:
    """A user-facing mode name -> its backend; unknown names raise."""
    if name not in ATTENTION_ALIASES:
        raise ValueError(f"Unknown attention backend: {name}")
    return ATTENTION_ALIASES[name]


def attention_xla(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H, D]
    v: torch.Tensor,  # [B, Sk, H, D]
    kv_valid: Optional[torch.Tensor] = None,  # [B, Sk] bool
    q_valid: Optional[torch.Tensor] = None,  # [B, Sq] bool (zeroes padded rows)
) -> torch.Tensor:
    """Plain attention: q k^T accumulated in fp32, fp32 softmax, the
    probabilities cast to v's dtype before PV. (The JAX function's q_valid
    branch raises on a [B, Sq] mask; here it zeroes the masked rows.)"""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_valid is not None:
        logits = torch.where(kv_valid[:, None, None, :], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(v.dtype)
    if q_valid is not None:
        out = out * q_valid[:, :, None, None].to(out.dtype)
    return out


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    q_valid: Optional[torch.Tensor] = None,
    backend: str = "xla",
) -> torch.Tensor:
    """Masked attention on [B, S, H, D]: K5 under "pallas", else the plain path."""
    if backend == "pallas":
        return flash_attention(q, k, v, kv_valid=kv_valid, q_valid=q_valid)
    return attention_xla(q, k, v, kv_valid=kv_valid, q_valid=q_valid)
