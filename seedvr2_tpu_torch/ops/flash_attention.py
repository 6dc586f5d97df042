"""K5: masked attention over [B, S, H, D] with an fp32 softmax.

Counterpart of seedvr2_tpu/ops/flash_attention.py:flash_attention, which the
DiT's unfused window attention calls under attention_mode flash_attn_2/3
("pallas"). On a CUDA tensor it launches the hand-written kernel (the
masked policy of csrc/flash_attention.cuh on the TMA + wgmma flash loop of
csrc/attention_pipeline.cuh, which K3 shares); on a CPU tensor it runs the
plain version.

The JAX function pads S to Sp = max(ceil(S / 128) * 128, 128) with masked
zero keys (an alignment need of the TPU compiler). Those keys enter its
softmax at logit -1e30: for a row with any valid key they weigh exactly 0,
and for a row whose keys are all masked they count in the denominator,
which makes such a row sum(v) / Sp. Both versions here count them the same
way, without materialising them.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

HEAD_DIM = 128  # the kernel's head dim (3B and 7B)
NEG = -1e30  # logit of a masked key, as in the JAX function


def padded_len(S: int) -> int:
    """The key count of the JAX function's padded softmax."""
    return max(-(-S // 128) * 128, 128)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    q_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The JAX kernel's math op for op: logits in fp32, masked keys at
    -1e30, fp32 softmax (a zero denominator replaced by 1), the
    probabilities cast to v's dtype before PV in fp32."""
    B, S, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / float(D) ** 0.5)
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, :], s, torch.full_like(s, NEG))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(-1, keepdim=True) + (padded_len(S) - S) * torch.exp(NEG - m)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    p = (e / denom).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)
    if q_valid is not None:
        out = out * q_valid[:, :, None, None].to(out.dtype)
    return out


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,  # [B, S] bool
    q_valid: Optional[torch.Tensor] = None,  # [B, S] bool: zero the other rows
) -> torch.Tensor:
    """Returns [B, S, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid, q_valid)
    B, S, H, D = q.shape
    cuda_lib.require(D == HEAD_DIM and S >= 1, f"flash_attention: q shape {tuple(q.shape)}")
    cuda_lib.require(H <= cuda_lib.MAX_GRID_YZ and B <= cuda_lib.MAX_GRID_YZ, f"flash_attention: H={H}, B={B}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.require_cuda_tensor(t, name, torch.bfloat16, (B, S, H, D))
    if kv_valid is None:
        kv_valid = torch.ones((B, S), dtype=torch.bool, device=q.device)
    cuda_lib.require_cuda_tensor(kv_valid, "kv_valid", torch.bool, (B, S))
    if q_valid is not None:
        cuda_lib.require_cuda_tensor(q_valid, "q_valid", torch.bool, (B, S))
    devs = {t.device for t in (k, v, kv_valid) + (() if q_valid is None else (q_valid,))}
    cuda_lib.require(devs == {q.device}, "flash_attention: tensors on different devices")
    out = torch.empty_like(q)
    lib = cuda_lib.library()
    with torch.cuda.device(q.device):
        code = lib.seedvr2_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
            0 if q_valid is None else q_valid.data_ptr(), out.data_ptr(),
            B, S, H, padded_len(S) - S, 1.0 / float(D) ** 0.5, cuda_lib.stream_ptr(q),
        )
    cuda_lib.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def kernel_attributes() -> dict:
    """K5's kernel as the CUDA runtime holds it: registers a thread, local
    memory (spills) a thread, and the dynamic shared memory it launches
    with."""
    return cuda_lib.attributes("seedvr2_flash_attention_attributes")
