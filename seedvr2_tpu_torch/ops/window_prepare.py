"""K11: K5's operands for the DiT's unfused window attention, prepared in
one pass.

Not a TPU kernel: the JAX package's unfused route
(seedvr2_tpu/models/dit/nadit.py:360 _window_attention) gathers q, k, v
into windows, rms-normalises q and k, ropes them and appends the text to
every window as XLA ops, which XLA fuses. ``window_prepare_plain`` is that
op sequence in PyTorch, the one the "xla" backend and every CPU tensor run.
Under "pallas" (flash_attn_2 / 3) on a CUDA tensor, ``window_prepare``
launches the hand-written kernel instead (csrc/window_prepare.cuh): it
reads the qkv projection's token-major output once through the plan's
index and writes the bf16 q, k, v that K5 (ops/flash_attention.py) takes,
norm and RoPE in fp32 registers with the plain version's op order and
roundings. It takes no other route: a CUDA tensor the kernel does not take
raises. Launch counter: ``window_prepare.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_lib
from .normalization import rms_norm
from .rope import rotate

HEAD_DIM = 128  # the kernel's head dim (3B and 7B)


def window_prepare_plain(
    vid_qkv, txt_qkv, index, vid_cos, vid_sin, txt_cos, txt_sin, rope_txt, norms, qk_norm, eps
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unfused route's preparation op for op: the window gather, q/k
    rms-normalised (fp32 statistics, rounded to the input dtype), roped in
    fp32 (rounded again; text only with ``rope_txt``), every window's text
    rows appended. Arguments as ``window_prepare``'s."""
    B, Lt, _, H, D = txt_qkv.shape
    per, mL = vid_cos.shape[:2]
    vq, vk, vv = vid_qkv.index_select(1, index).reshape(B, per, mL, 3, H, D).unbind(3)
    tq, tk, tv = txt_qkv.unbind(2)
    if qk_norm:
        vq, vk = rms_norm(vq, norms[0], eps), rms_norm(vk, norms[1], eps)
        tq, tk = rms_norm(tq, norms[2], eps), rms_norm(tk, norms[3], eps)
    cos, sin = vid_cos[None, :, :, None], vid_sin[None, :, :, None]  # [1, per, mL, 1, D]
    vq, vk = rotate(vq, cos, sin).to(vq.dtype), rotate(vk, cos, sin).to(vk.dtype)
    if rope_txt:
        tcos, tsin = txt_cos[None, :, None], txt_sin[None, :, None]  # [1, Lt, 1, D]
        tq, tk = rotate(tq, tcos, tsin).to(tq.dtype), rotate(tk, tcos, tsin).to(tk.dtype)

    def with_txt(vw, tw):  # [B, per, mL, H, D] + [B, Lt, H, D] -> [B * per, mL + Lt, H, D]
        return torch.cat([vw, tw[:, None].expand(B, per, Lt, H, D)], dim=2).reshape(B * per, mL + Lt, H, D)

    return with_txt(vq, tq), with_txt(vk, tk), with_txt(vv, tv)


def window_prepare(
    vid_qkv: torch.Tensor,  # [B, Lv, 3, H, D]: the qkv projection's output, token-major
    txt_qkv: torch.Tensor,  # [B, Lt, 3, H, D]
    index: torch.Tensor,  # [per * mL] long: the token of each window slot (padding slots name a real one)
    vid_cos: torch.Tensor,  # [per, mL, D] fp32 (angles zero-padded to D)
    vid_sin: torch.Tensor,
    txt_cos: torch.Tensor,  # [Lt, D] fp32 (read only when rope_txt)
    txt_sin: torch.Tensor,
    rope_txt: bool,
    norms: torch.Tensor,  # [4, D] fp32: q_vid, k_vid, q_txt, k_txt weights
    qk_norm: bool = True,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns K5's (q, k, v), each [B * per, mL + Lt, H, D] in the input
    dtype: window w of batch b at row b * per + w, its mL video slots, then
    the Lt text rows. The index is the plan's (models/dit/windows.py), not
    checked against Lv on the card."""
    if vid_qkv.device.type == "cpu":
        return window_prepare_plain(vid_qkv, txt_qkv, index, vid_cos, vid_sin, txt_cos, txt_sin, rope_txt, norms,
                                    qk_norm, eps)
    B, Lv, three, H, D = vid_qkv.shape
    per, mL = vid_cos.shape[:2]
    Lt = txt_qkv.shape[1]
    cuda_lib.require(three == 3 and D == HEAD_DIM and Lv >= 1 and per >= 1 and mL >= 1,
                     f"window_prepare: qkv shape {tuple(vid_qkv.shape)}, tables {tuple(vid_cos.shape)}")
    cuda_lib.require(per <= cuda_lib.MAX_GRID_YZ and B <= cuda_lib.MAX_GRID_YZ, f"window_prepare: per={per}, B={B}")
    dev = vid_qkv.device
    cuda_lib.require_cuda_tensor(vid_qkv, "vid_qkv", torch.bfloat16)
    cuda_lib.require_cuda_tensor(txt_qkv, "txt_qkv", torch.bfloat16, (B, Lt, 3, H, D), dev)
    cuda_lib.require_cuda_tensor(index, "index", torch.int64, (per * mL,), dev)
    for name, t in (("vid_cos", vid_cos), ("vid_sin", vid_sin)):
        cuda_lib.require_cuda_tensor(t, name, torch.float32, (per, mL, D), dev)
    for name, t in (("txt_cos", txt_cos), ("txt_sin", txt_sin)):
        cuda_lib.require_cuda_tensor(t, name, torch.float32, (Lt, D), dev)
    cuda_lib.require_cuda_tensor(norms, "norms", torch.float32, (4, D), dev)
    out = torch.empty((3, B * per, mL + Lt, H, D), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        code = cuda_lib.library().seedvr2_window_prepare(
            vid_qkv.data_ptr(), txt_qkv.data_ptr(), index.data_ptr(), vid_cos.data_ptr(), vid_sin.data_ptr(),
            txt_cos.data_ptr(), txt_sin.data_ptr(), norms.data_ptr(), out.data_ptr(), B, Lv, H, per, mL, Lt,
            int(rope_txt), int(qk_norm), float(eps), cuda_lib.stream_ptr(vid_qkv),
        )
    cuda_lib.check(code, "window_prepare")
    window_prepare.launches += 1
    return out.unbind(0)


window_prepare.launches = 0
