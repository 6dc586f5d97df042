"""K3 and K3q: fused window attention (qk rms-norm + RoPE + per-window text
keys + masked softmax + PV), head-major.

Counterpart of seedvr2_tpu/ops/fused_window_attention.py:
fused_window_attention. ``quant_qk=False`` is K3; ``quant_qk=True`` is K3q,
the attention_mode sageattn_2/3 ("fused_int8"): after q and k are
normalised, roped and rounded, each q and k row is quantised to int8 with
its own fp32 scale and the logits are the int32 dot products times both
scales; softmax and PV are unchanged. On a CUDA tensor the wrapper launches
the hand-written kernel (the window policy of csrc/window_attention.cuh on
the flash core csrc/attention_core.cuh, one template for both); on a CPU
tensor it runs the plain version, which is the Pallas kernel's math op for
op.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_lib
from .rope import rotate

HEAD_DIM = 128  # the kernel's head dim (3B and 7B)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 (SageAttention's q/k scheme), in the Pallas
    kernel's op order: s = max|x| * (1/127) + 1e-8 in fp32, codes round(x / s)
    with ties to even. Codes are returned as exact fp32 integers."""
    xf = x.float()
    s = xf.abs().amax(-1, keepdim=True) * (1.0 / 127.0) + 1e-8
    return torch.round(xf / s), s


def fused_window_attention_plain(
    vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, valid, rope_txt, norms, qk_norm, eps, quant_qk=False
) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = vid_qkv.dtype
    D = vid_qkv.shape[-1]
    scale = 1.0 / float(D) ** 0.5
    vq, vk, vv = vid_qkv.unbind(1)  # [B, H, nW, S, D]
    tq, tk, tv = txt_qkv.unbind(1)  # [B, H, Lt, D]

    def norm(x, row):
        if not qk_norm:
            return x
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * (1.0 / torch.sqrt(var + eps)) * norms[row].float()).to(dt)

    vq = rotate(norm(vq, 0), vid_cos, vid_sin).to(dt)
    vk = rotate(norm(vk, 1), vid_cos, vid_sin).to(dt)
    tq, tk = norm(tq, 2), norm(tk, 3)
    if rope_txt:
        tq = rotate(tq, txt_cos, txt_sin).to(dt)
        tk = rotate(tk, txt_cos, txt_sin).to(dt)
    key_ok = valid.bool()[None, None, :, None, :]  # [1, 1, nW, 1, S]

    def qk(eq, a, b):
        if not quant_qk:
            return torch.einsum(eq, a.float(), b.float()) * scale
        (a8, sa), (b8, sb) = quantize_rows(a), quantize_rows(b)
        sb = sb.transpose(-1, -2)  # [..., 1, keys]
        if b.dim() == 4:  # text keys: one set for every window
            sb = sb.unsqueeze(2)
        # |int dot| <= 128 * 127^2 < 2^24: the fp32 sum of integer products is exact
        return torch.einsum(eq, a8, b8) * (sa * scale) * sb

    def attend(q):  # q [B, H, nW, M, D]
        s_v = qk("bhwqd,bhwkd->bhwqk", q, vk)
        s_v = torch.where(key_ok, s_v, torch.full_like(s_v, -1e30))
        s_t = qk("bhwqd,bhkd->bhwqk", q, tk)
        m = torch.maximum(s_v.amax(-1, keepdim=True), s_t.amax(-1, keepdim=True))
        e_v, e_t = torch.exp(s_v - m), torch.exp(s_t - m)
        den = e_v.sum(-1, keepdim=True) + e_t.sum(-1, keepdim=True)
        inv = 1.0 / torch.where(den == 0.0, torch.ones_like(den), den)
        out = torch.einsum("bhwqk,bhwkd->bhwqd", (e_v * inv).to(dt).float(), vv.float())
        out = out + torch.einsum("bhwqk,bhkd->bhwqd", (e_t * inv).to(dt).float(), tv.float())
        return out.to(dt)

    nW = vid_qkv.shape[3]
    return attend(vq), attend(tq[:, :, None].expand(-1, -1, nW, -1, -1))


def fused_window_attention(
    vid_qkv: torch.Tensor,  # [B, 3, H, nW, S, D] windowed, head-major
    txt_qkv: torch.Tensor,  # [B, 3, H, Lt, D]
    vid_cos: torch.Tensor,  # [nW, S, D] fp32 (angles zero-padded to D)
    vid_sin: torch.Tensor,
    txt_cos: torch.Tensor,  # [Lt, D] fp32 (read only when rope_txt)
    txt_sin: torch.Tensor,
    valid: torch.Tensor,  # [nW, S] bool: video slot holds a token
    rope_txt: bool,
    norms: torch.Tensor,  # [4, D] fp32: q_vid, k_vid, q_txt, k_txt weights
    qk_norm: bool = True,
    eps: float = 1e-5,
    quant_qk: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (vid_out [B, H, nW, S, D], txt_out [B, H, nW, Lt, D]).
    Launches are counted per kernel: ``.launches`` for K3, ``.launches_int8``
    for K3q."""
    if vid_qkv.device.type == "cpu":
        return fused_window_attention_plain(
            vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, valid, rope_txt, norms, qk_norm, eps, quant_qk
        )
    B, three, H, nW, S, D = vid_qkv.shape
    Lt = txt_qkv.shape[3]
    cuda_lib.require(three == 3 and D == HEAD_DIM, f"fused_window_attention: qkv shape {tuple(vid_qkv.shape)}")
    cuda_lib.require(Lt >= 1 and S >= 1, f"fused_window_attention: S={S} Lt={Lt}")
    cuda_lib.require(nW * H <= cuda_lib.MAX_GRID_YZ and B <= cuda_lib.MAX_GRID_YZ, f"fused_window_attention: nW*H={nW * H}, B={B}")
    cuda_lib.require_cuda_tensor(vid_qkv, "vid_qkv", torch.bfloat16)
    cuda_lib.require_cuda_tensor(txt_qkv, "txt_qkv", torch.bfloat16, (B, 3, H, Lt, D))
    for name, t in (("vid_cos", vid_cos), ("vid_sin", vid_sin)):
        cuda_lib.require_cuda_tensor(t, name, torch.float32, (nW, S, D))
    for name, t in (("txt_cos", txt_cos), ("txt_sin", txt_sin)):
        cuda_lib.require_cuda_tensor(t, name, torch.float32, (Lt, D))
    cuda_lib.require_cuda_tensor(valid, "valid", torch.bool, (nW, S))
    cuda_lib.require_cuda_tensor(norms, "norms", torch.float32, (4, D))
    devs = {t.device for t in (txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, valid, norms)}
    cuda_lib.require(devs == {vid_qkv.device}, "fused_window_attention: tensors on different devices")
    ovid = torch.empty((B, H, nW, S, D), dtype=torch.bfloat16, device=vid_qkv.device)
    otxt = torch.empty((B, H, nW, Lt, D), dtype=torch.bfloat16, device=vid_qkv.device)
    lib = cuda_lib.library()
    with torch.cuda.device(vid_qkv.device):
        code = lib.seedvr2_window_attention(
            vid_qkv.data_ptr(), txt_qkv.data_ptr(), vid_cos.data_ptr(), vid_sin.data_ptr(),
            txt_cos.data_ptr(), txt_sin.data_ptr(), valid.data_ptr(), norms.data_ptr(),
            ovid.data_ptr(), otxt.data_ptr(), B, H, nW, S, Lt, int(rope_txt), int(qk_norm), int(quant_qk),
            float(eps), 1.0 / float(D) ** 0.5, cuda_lib.stream_ptr(vid_qkv),
        )
    cuda_lib.check(code, "fused_window_attention")
    if quant_qk:
        fused_window_attention.launches_int8 += 1
    else:
        fused_window_attention.launches += 1
    return ovid, otxt


fused_window_attention.launches = 0  # K3
fused_window_attention.launches_int8 = 0  # K3q
