"""K3 and K3q: fused window attention (qk rms-norm + RoPE + per-window text
keys + masked softmax + PV), head-major.

Counterpart of seedvr2_tpu/ops/fused_window_attention.py:
fused_window_attention. ``quant_qk=False`` is K3; ``quant_qk=True`` is K3q,
the attention_mode sageattn_2/3 ("fused_int8"): after q and k are
normalised, roped and rounded, each q and k row is quantised to int8 with
its own fp32 scale and the logits are the int32 dot products times both
scales; softmax and PV are unchanged. On a CUDA tensor the wrapper launches
two hand-written kernels back to back: the q/k preparation
(csrc/window_qk_prepare.cuh: every row normalised and roped once, K3q's
codes and scales, into scratch allocated here) and the flash loop
(csrc/window_attention.cuh on csrc/attention_pipeline.cuh: TMA, mbarrier
rings, wgmma); one call counts one launch of K3 or K3q. On a CPU tensor it
runs the plain version, the Pallas kernel's math op for op, split the same
way: ``qk_prepare_plain`` then ``window_attention_prepared_plain``.

K3s (``fused_window_attention_sharded``) is K3 or K3q on one rank's part of
a sharded DiT: its windows of the seq axis (``window_range``) and whatever
heads it is given (under tensor, its heads / tensor from the
column-parallel qkv). Windows are independent, so it runs no collective;
the gathers around it are the DiT's (models/dit/nadit.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_lib
from .rope import rotate

HEAD_DIM = 128  # the kernel's head dim (3B and 7B)
TILE = 64  # the flash loop's query and key tile: the prepared scales and key codes are padded to it


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 (SageAttention's q/k scheme), in the Pallas
    kernel's op order: s = max|x| * (1/127) + 1e-8 in fp32, codes round(x / s)
    with ties to even. Codes are returned as exact fp32 integers."""
    xf = x.float()
    s = xf.abs().amax(-1, keepdim=True) * (1.0 / 127.0) + 1e-8
    return torch.round(xf / s), s


def qk_prepare_plain(vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, rope_txt, norms, qk_norm, eps):
    """The first step of the plain version: q and k rms-normalised (fp32
    stats, rounded to the input dtype) and roped (fp32, rounded again), as
    the Pallas kernel prepares them. Returns (q_vid, k_vid [B, H, nW, S, D],
    q_txt, k_txt [B, H, Lt, D]); K3q quantises these rows (quantize_rows)."""
    dt = vid_qkv.dtype

    def norm(x, row):
        if not qk_norm:
            return x
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * (1.0 / torch.sqrt(var + eps)) * norms[row].float()).to(dt)

    vq = rotate(norm(vid_qkv[:, 0], 0), vid_cos, vid_sin).to(dt)
    vk = rotate(norm(vid_qkv[:, 1], 1), vid_cos, vid_sin).to(dt)
    tq, tk = norm(txt_qkv[:, 0], 2), norm(txt_qkv[:, 1], 3)
    if rope_txt:
        tq = rotate(tq, txt_cos, txt_sin).to(dt)
        tk = rotate(tk, txt_cos, txt_sin).to(dt)
    return vq, vk, tq, tk


def window_attention_prepared_plain(vq, vk, vv, tq, tk, tv, valid, quant_qk=False):
    """The second step of the plain version: the window attention of
    prepared q/k rows (qk_prepare_plain's) over [window video ; all text]
    keys, padded video slots masked at -1e30, an fp32 softmax, probabilities
    in the input dtype before PV. Returns (vid [B, H, nW, S, D], txt [B, H,
    nW, Lt, D])."""
    dt = vq.dtype
    scale = 1.0 / float(vq.shape[-1]) ** 0.5
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

    nW = vq.shape[2]
    return attend(vq), attend(tq[:, :, None].expand(-1, -1, nW, -1, -1))


def fused_window_attention_plain(
    vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, valid, rope_txt, norms, qk_norm, eps, quant_qk=False
) -> Tuple[torch.Tensor, torch.Tensor]:
    vq, vk, tq, tk = qk_prepare_plain(vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, rope_txt, norms, qk_norm,
                                      eps)
    return window_attention_prepared_plain(vq, vk, vid_qkv[:, 2], tq, tk, txt_qkv[:, 2], valid, quant_qk)


class Prepared(NamedTuple):
    """The scratch of one K3 / K3q call, written by the preparation kernel:
    q/k rows (bf16 for K3, int8 codes for K3q) video [B, H, nW, S, D] and text
    [B, H, Lt, D]; K3q's row scales, video [B, H, nW, Sp] and text [B, H,
    Ltp] (Sp, Ltp: S, Lt rounded up to TILE; 0 past the rows); the window's
    key codes [nW, Sp] (0: a key; -inf: a padded slot or past S) and key-tile
    flags [nW, Sp / TILE] (1: the tile holds a key; the flash loop skips
    the others)."""

    q_vid: torch.Tensor
    k_vid: torch.Tensor
    q_txt: torch.Tensor
    k_txt: torch.Tensor
    qs_vid: Optional[torch.Tensor]
    ks_vid: Optional[torch.Tensor]
    qs_txt: Optional[torch.Tensor]
    ks_txt: Optional[torch.Tensor]
    kcode: torch.Tensor
    tile_live: torch.Tensor


def _check(vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, valid, norms) -> None:
    B, three, H, nW, S, D = vid_qkv.shape
    Lt = txt_qkv.shape[3]
    cuda_lib.require(three == 3 and D == HEAD_DIM, f"fused_window_attention: qkv shape {tuple(vid_qkv.shape)}")
    cuda_lib.require(Lt >= 1 and S >= 1, f"fused_window_attention: S={S} Lt={Lt}")
    cuda_lib.require(nW + 1 <= cuda_lib.MAX_GRID_YZ and B <= cuda_lib.MAX_GRID_YZ, f"fused_window_attention: nW={nW}, B={B}")
    cuda_lib.require_cuda_tensor(vid_qkv, "vid_qkv", torch.bfloat16)
    dev = vid_qkv.device
    cuda_lib.require_cuda_tensor(txt_qkv, "txt_qkv", torch.bfloat16, (B, 3, H, Lt, D), dev)
    for name, t in (("vid_cos", vid_cos), ("vid_sin", vid_sin)):
        cuda_lib.require_cuda_tensor(t, name, torch.float32, (nW, S, D), dev)
    for name, t in (("txt_cos", txt_cos), ("txt_sin", txt_sin)):
        cuda_lib.require_cuda_tensor(t, name, torch.float32, (Lt, D), dev)
    cuda_lib.require_cuda_tensor(valid, "valid", torch.bool, (nW, S), dev)
    cuda_lib.require_cuda_tensor(norms, "norms", torch.float32, (4, D), dev)


def qk_prepare(lib, vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, valid, rope_txt, norms, qk_norm, eps,
               quant_qk) -> Prepared:
    """Launches the preparation kernel of library ``lib`` (checked inputs,
    see fused_window_attention) into new scratch."""
    B, _, H, nW, S, D = vid_qkv.shape
    Lt = txt_qkv.shape[3]
    Sp, Ltp = -(-S // TILE) * TILE, -(-Lt // TILE) * TILE
    dev = vid_qkv.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    rows = torch.int8 if quant_qk else torch.bfloat16
    scales = (empty(B, H, nW, Sp), empty(B, H, nW, Sp), empty(B, H, Ltp), empty(B, H, Ltp)) if quant_qk else (None,) * 4
    prep = Prepared(empty(B, H, nW, S, D, dtype=rows), empty(B, H, nW, S, D, dtype=rows), empty(B, H, Lt, D, dtype=rows),
                    empty(B, H, Lt, D, dtype=rows), *scales, empty(nW, Sp), empty(nW, Sp // TILE, dtype=torch.uint8))
    ptr = [t.data_ptr() if t is not None else None for t in prep]
    with torch.cuda.device(dev):
        code = lib.seedvr2_window_qk_prepare(
            vid_qkv.data_ptr(), txt_qkv.data_ptr(), vid_cos.data_ptr(), vid_sin.data_ptr(), txt_cos.data_ptr(),
            txt_sin.data_ptr(), valid.data_ptr(), norms.data_ptr(), *ptr, B, H, nW, S, Lt, int(rope_txt),
            int(qk_norm), int(quant_qk), float(eps), cuda_lib.stream_ptr(vid_qkv),
        )
    cuda_lib.check(code, "window_qk_prepare")
    return prep


def window_flash(lib, vid_qkv, txt_qkv, prep: Prepared, quant_qk) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the flash loop of library ``lib`` on prepared rows; V is read
    from the qkv tensors. Returns (vid [B, H, nW, S, D], txt [B, H, nW, Lt, D])."""
    B, _, H, nW, S, D = vid_qkv.shape
    Lt = txt_qkv.shape[3]
    ovid = torch.empty((B, H, nW, S, D), dtype=torch.bfloat16, device=vid_qkv.device)
    otxt = torch.empty((B, H, nW, Lt, D), dtype=torch.bfloat16, device=vid_qkv.device)
    ptr = [t.data_ptr() if t is not None else None for t in prep]
    with torch.cuda.device(vid_qkv.device):
        code = lib.seedvr2_window_flash(
            vid_qkv.data_ptr(), txt_qkv.data_ptr(), *ptr, ovid.data_ptr(), otxt.data_ptr(), B, H, nW, S, Lt,
            int(quant_qk), 1.0 / float(D) ** 0.5, cuda_lib.stream_ptr(vid_qkv),
        )
    cuda_lib.check(code, "window_flash")
    return ovid, otxt


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
    Launches are counted per call (the preparation and the flash loop
    together): ``.launches`` for K3, ``.launches_int8`` for K3q."""
    if vid_qkv.device.type == "cpu":
        return fused_window_attention_plain(
            vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, valid, rope_txt, norms, qk_norm, eps, quant_qk
        )
    _check(vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, valid, norms)
    lib = cuda_lib.library()
    prep = qk_prepare(lib, vid_qkv, txt_qkv, vid_cos, vid_sin, txt_cos, txt_sin, valid, rope_txt, norms, qk_norm, eps,
                      quant_qk)
    out = window_flash(lib, vid_qkv, txt_qkv, prep, quant_qk)
    if quant_qk:
        fused_window_attention.launches_int8 += 1
    else:
        fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0  # K3
fused_window_attention.launches_int8 = 0  # K3q


# --------------------------------------------------------------------------- #
# K3s: one rank's windows
# --------------------------------------------------------------------------- #


def window_range(n_win: int, seq_size: int, seq_rank: int) -> Tuple[int, int, int]:
    """(first, end, per_rank): rank r of s attends windows [first, end) of
    ``n_win`` and launches per_rank = ceil(n_win / s) of them, its tail
    padded with all-invalid windows as in the JAX package, so that every
    rank's launch and every all-gather has one size and no rank launches
    zero windows."""
    per = max(1, -(-n_win // seq_size))
    first = min(seq_rank * per, n_win)
    return first, min(first + per, n_win), per


def pad_windows(t: torch.Tensor, dim: int, n: int, fill) -> torch.Tensor:
    """A new tensor: ``t`` padded along ``dim`` to ``n`` with ``fill`` (a
    copy even without padding: a slice of rows starts at an offset the
    kernel's 16-byte alignment check may refuse)."""
    extra = n - t.shape[dim]
    if extra == 0:
        return t.clone(memory_format=torch.contiguous_format)
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, torch.full(shape, fill, dtype=t.dtype, device=t.device)], dim=dim)


def shard_window_tables(vid_cos, vid_sin, valid, seq_rank: int, seq_size: int):
    """A rank's rows of the plan tables [nW, ...] -> [per_rank, ...]; padded
    windows are all-invalid, with angle 0 (cos 1, sin 0) as JAX pads them.
    One rank: the tables themselves."""
    if seq_size == 1:
        return vid_cos, vid_sin, valid
    first, end, per = window_range(valid.shape[0], seq_size, seq_rank)
    return (pad_windows(vid_cos[first:end], 0, per, 1.0), pad_windows(vid_sin[first:end], 0, per, 0.0),
            pad_windows(valid[first:end], 0, per, False))


def fused_window_attention_sharded(
    vid_qkv: torch.Tensor,  # [B, 3, h, nW, S, D] every window, or [B, 3, h, per_rank, S, D] this rank's
    txt_qkv: torch.Tensor,  # [B, 3, h, Lt, D]
    vid_cos: torch.Tensor,  # [nW, S, D] fp32: the whole plan's tables
    vid_sin: torch.Tensor,
    txt_cos: torch.Tensor,  # [Lt, D]
    txt_sin: torch.Tensor,
    valid: torch.Tensor,  # [nW, S] bool
    rope_txt: bool,
    norms: torch.Tensor,  # [4, D]
    qk_norm: bool = True,
    eps: float = 1e-5,
    quant_qk: bool = False,
    seq_rank: int = 0,
    seq_size: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3s, counterpart of seedvr2_tpu/ops/fused_window_attention.py:
    fused_window_attention_sharded: K3 (K3q with ``quant_qk``, which the
    JAX function drops) on rank ``seq_rank`` of ``seq_size``'s windows
    (``window_range``) and the heads of ``vid_qkv``. ``vid_qkv`` holds every
    window of the plan (sliced here, the tail zero-padded as JAX pads it) or
    already this rank's per_rank windows (the DiT gathers only those). The
    batch is whatever the rank holds: under frame data parallelism each
    rank runs its own segment. Returns this rank's (vid [B, h, per_rank, S,
    D], txt [B, h, per_rank, Lt, D]): windows first..end-1, then the
    padding. Launches are counted as K3's: ``.launches`` for K3,
    ``.launches_int8`` for K3q."""
    n_win = valid.shape[0]
    first, end, per = window_range(n_win, seq_size, seq_rank)
    if vid_qkv.shape[3] == n_win and (first, end, per) != (0, n_win, n_win):  # not this rank's windows alone
        vid_qkv = pad_windows(vid_qkv[:, :, :, first:end], 3, per, 0.0)
    elif vid_qkv.shape[3] not in (n_win, per):
        raise ValueError(f"fused_window_attention_sharded: {vid_qkv.shape[3]} windows, expected {n_win} or {per}")
    cos, sin, vld = shard_window_tables(vid_cos, vid_sin, valid, seq_rank, seq_size)
    out = fused_window_attention(vid_qkv, txt_qkv, cos, sin, txt_cos, txt_sin, vld, rope_txt, norms, qk_norm, eps,
                                 quant_qk=quant_qk)
    if vid_qkv.is_cuda:  # K3 / K3q launched
        if quant_qk:
            fused_window_attention_sharded.launches_int8 += 1
        else:
            fused_window_attention_sharded.launches += 1
    return out


fused_window_attention_sharded.launches = 0  # K3s over K3
fused_window_attention_sharded.launches_int8 = 0  # K3s over K3q
