"""NaDiT-3B and NaDiT-7B (counterpart of seedvr2_tpu/models/dit/nadit.py);
layers run as a Python loop.

Dense [B, L, D] tokens; 3D shifted-window attention over padded windows
with a validity mask (plans from models/dit/windows.py); text tokens attend
inside every window and their outputs are averaged over windows;
AdaLN-single modulation; SwiGLU (3B) or GELU (7B) MLP; 3B layers from
mm_layers on share one set of weights for both streams and its last layer
is video-only; 3B ropes text too (mmrope3d), 7B only video (window_pixel).

The attention mode (ops/attention.py) picks the window attention of every
layer: "fused" and "fused_int8" run K3 / K3q on head-major q, k, v with
norm and RoPE inside the kernel; "pallas" and "xla" gather, normalise and
rope outside, append the text to every window and call K5 or the plain
attention.

Under parallel/sp.py's ``sharded_dit`` the forward runs on one rank's part:
its token slice (seq) and its heads and MLP columns (tensor, with weights
split by parallel/sharding.py), with the collectives of parallel/comm.py
(see ``_window_attention_fused``); without it, on one rank, nothing
changes.

Quirk kept on purpose: the 3B output modulation (vid_out_ada) uses the
attn-layer slice of the time embedding, as the reference does through a
shared cache key; checkpoint parity needs it.
"""

from __future__ import annotations

import math
from typing import Collection, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config import DiTConfig
from ...ops.attention import attention, resolve_attention_mode
from ...ops.fused_window_attention import (
    fused_window_attention,
    fused_window_attention_sharded,
    shard_window_tables,
    window_range,
)
from ...ops.normalization import rms_norm
from ...ops import quant
from ...ops.rope import axial_freqs_lang, axial_freqs_pixel, pad_angles, rotate
from ...parallel.comm import all_gather_cat, all_reduce_sum, pad_to
from ...parallel.sharding import check_tensor_split
from ...parallel.sp import ShardingHints, current_hints
from ..params import NORMAL, ONES, ONES_PLUS_NORMAL, Leaf, Linear, branch, leaf_paths
from .windows import WindowPlan, window_plan

# --------------------------------------------------------------------------- #
# Static per-shape attention plans (host numpy) and their device copies
# --------------------------------------------------------------------------- #


class LayerPlan(NamedTuple):
    plan: WindowPlan
    vid_angles: Optional[np.ndarray]  # [n_win, max_len, head_dim] or None
    txt_angles: Optional[np.ndarray]  # [txt_len, head_dim] or None


class AttnPlans(NamedTuple):
    plain: LayerPlan
    shifted: LayerPlan
    thw: Tuple[int, int, int]
    txt_len: int


def _rope_angles_for_plan(cfg: DiTConfig, plan: WindowPlan, txt_len: int):
    per = (cfg.rope_dim // 3) & ~1
    rot3 = per * 3
    vid = np.zeros((plan.n_win, plan.max_len, rot3), dtype=np.float32)
    if cfg.rope_type == "mmrope3d":
        for i, (t, h, w) in enumerate(plan.shapes):
            vid[i, : t * h * w] = axial_freqs_lang((t, h, w), per, offsets=(txt_len, 0, 0)).reshape(-1, rot3)
        txt_axis = axial_freqs_lang((txt_len,), per) if txt_len else np.zeros((0, per), np.float32)
        txt = np.tile(txt_axis.reshape(txt_len, per), (1, 3)).astype(np.float32)
        return pad_angles(vid, cfg.head_dim), pad_angles(txt, cfg.head_dim)
    if cfg.rope_type == "window_pixel":
        for i, (t, h, w) in enumerate(plan.shapes):
            vid[i, : t * h * w] = axial_freqs_pixel((t, h, w), per).reshape(-1, rot3)
        return pad_angles(vid, cfg.head_dim), None  # 7B does not rope text
    if cfg.rope_type in (None, "none"):
        return None, None  # no RoPE: DevicePlan's zero angles rotate by the identity
    raise NotImplementedError(cfg.rope_type)


def build_attn_plans(cfg: DiTConfig, thw: Tuple[int, int, int], txt_len: int) -> AttnPlans:
    """Host-side constants for one (patched latent shape, text length)."""
    layer_plans = []
    for shifted in (False, True):
        plan = window_plan(thw, cfg.window, shifted=shifted)
        layer_plans.append(LayerPlan(plan, *_rope_angles_for_plan(cfg, plan, txt_len)))
    return AttnPlans(layer_plans[0], layer_plans[1], thw, txt_len)


class DevicePlan(NamedTuple):
    """One LayerPlan as the tensors K3 and the gathers take."""

    index: torch.Tensor  # [n_win * max_len] long
    inverse: torch.Tensor  # [L] long
    valid: torch.Tensor  # [n_win, max_len] bool
    vid_cos: torch.Tensor  # [n_win, max_len, head_dim] fp32
    vid_sin: torch.Tensor
    txt_cos: torch.Tensor  # [txt_len, head_dim] fp32
    txt_sin: torch.Tensor
    rope_txt: bool

    @staticmethod
    def build(lp: LayerPlan, head_dim: int, txt_len: int, device) -> "DevicePlan":
        p = lp.plan
        vang = lp.vid_angles if lp.vid_angles is not None else np.zeros((p.n_win, p.max_len, head_dim), np.float32)
        rope_txt = lp.txt_angles is not None and txt_len > 0
        tang = lp.txt_angles if rope_txt else np.zeros((txt_len, head_dim), np.float32)
        v = torch.from_numpy(np.ascontiguousarray(vang)).to(device)
        t = torch.from_numpy(np.ascontiguousarray(tang)).to(device)
        return DevicePlan(
            torch.from_numpy(p.index.reshape(-1).astype(np.int64)).to(device),
            torch.from_numpy(p.inverse.astype(np.int64)).to(device),
            torch.from_numpy(p.valid).to(device),
            torch.cos(v), torch.sin(v), torch.cos(t), torch.sin(t), rope_txt,
        )


def device_plans(plans: AttnPlans, head_dim: int, device) -> Tuple[DevicePlan, DevicePlan]:
    return tuple(DevicePlan.build(lp, head_dim, plans.txt_len, device) for lp in (plans.plain, plans.shifted))


# --------------------------------------------------------------------------- #
# Modules (named after the JAX parameter tree)
# --------------------------------------------------------------------------- #


def _mm(make, shared: bool, vid_only: bool) -> nn.ModuleDict:
    """vid/txt branches, or one shared 'all' branch (MMModule); ``make``
    takes the branch's name."""
    names = ("all",) if shared else ("vid",) if vid_only else ("vid", "txt")
    return nn.ModuleDict({n: make(n) for n in names})


def _ada_leaf(dim: int, device, dtype, layers=("attn", "mlp"), modes=("in", "out")) -> Leaf:
    s = dim**-0.5
    spec = {}
    for l in layers:
        if "in" in modes:
            spec[f"{l}_shift"] = ((dim,), (NORMAL, s))
            spec[f"{l}_scale"] = ((dim,), (ONES_PLUS_NORMAL, s))
        if "out" in modes:
            spec[f"{l}_gate"] = ((dim,), (NORMAL, s))
    return Leaf(spec, device, dtype)


def mlp_hidden(cfg: DiTConfig) -> int:
    """The MLP's hidden width (SwiGLU: 2/3 of expand_ratio * D, rounded up)."""
    if cfg.mlp_type == "swiglu":
        m = cfg.swiglu_multiple_of
        return m * ((int(2 * cfg.vid_dim * cfg.expand_ratio / 3) + m - 1) // m)
    return cfg.vid_dim * cfg.expand_ratio


def _row_linear(lin: Linear, x: torch.Tensor, hints: Optional[ShardingHints]) -> torch.Tensor:
    """x @ w + b for a row-parallel layer: under tensor sharding the partial
    products (int8: already scaled, the scale being per output column) are
    summed over the tensor group first and the bias is added once, after
    the sum (not on every rank)."""
    y = lin(x, bias=False)
    if hints is not None:
        y = all_reduce_sum(y, hints.tensor_group)
    return y + lin.b if "b" in lin.spec else y


class MLP(nn.Module):
    """``tensor`` > 1: this rank's hidden columns (proj_in, proj_in_gate
    column-parallel, proj_out row-parallel). ``int8(name)``: the linear
    ``name`` holds int8 weights."""

    def __init__(self, cfg: DiTConfig, device, dtype, tensor: int = 1, int8=lambda name: False):
        super().__init__()
        D = cfg.vid_dim
        hidden = mlp_hidden(cfg) // tensor
        self.swiglu = cfg.mlp_type == "swiglu"
        if self.swiglu:
            self.proj_in_gate = Linear(D, hidden, device, dtype, bias=False, quant=int8("proj_in_gate"))
            self.proj_in = Linear(D, hidden, device, dtype, bias=False, quant=int8("proj_in"))
            self.proj_out = Linear(hidden, D, device, dtype, bias=False, quant=int8("proj_out"))
        else:
            self.proj_in = Linear(D, hidden, device, dtype, quant=int8("proj_in"))
            self.proj_out = Linear(hidden, D, device, dtype, quant=int8("proj_out"))

    def forward(self, x: torch.Tensor, hints: Optional[ShardingHints] = None) -> torch.Tensor:
        if self.swiglu:
            h = F.silu(self.proj_in_gate(x).float()).to(x.dtype) * self.proj_in(x)
        else:
            h = F.gelu(self.proj_in(x).float(), approximate="tanh").to(x.dtype)
        return _row_linear(self.proj_out, h, hints)


class Attention(nn.Module):
    """``tensor`` > 1: this rank's heads (qkv column-parallel, out
    row-parallel). ``int8(path)``: the linear at ``path`` ("qkv/vid")
    holds int8 weights."""

    def __init__(self, cfg: DiTConfig, shared: bool, device, dtype, tensor: int = 1, int8=lambda path: False):
        super().__init__()
        D, inner, hd = cfg.vid_dim, cfg.inner_dim // tensor, cfg.head_dim
        self.qkv = _mm(lambda b: Linear(D, (3, inner), device, dtype, bias=cfg.qk_bias, quant=int8(f"qkv/{b}")),
                       shared, False)
        self.out = _mm(lambda b: Linear(inner, D, device, dtype, quant=int8(f"out/{b}")), shared, False)
        self.norm_q = _mm(lambda b: Leaf({"w": ((hd,), (ONES, 0.0))}, device, dtype), shared, False)
        self.norm_k = _mm(lambda b: Leaf({"w": ((hd,), (ONES, 0.0))}, device, dtype), shared, False)


class Block(nn.Module):
    """``int8``: the paths of the DiT's int8 linears (NaDiT)."""

    def __init__(self, cfg: DiTConfig, layer: int, device, dtype, tensor: int = 1, int8: Collection[str] = ()):
        super().__init__()
        shared, vid_only = cfg.shared_weights(layer), cfg.vid_only(layer)
        self.vid_only = vid_only
        self.attn = Attention(cfg, shared, device, dtype, tensor, lambda p: f"blocks/{layer}/attn/{p}" in int8)
        self.mlp = _mm(lambda b: MLP(cfg, device, dtype, tensor, lambda n: f"blocks/{layer}/mlp/{b}/{n}" in int8),
                       shared, vid_only)
        self.ada = _mm(lambda b: _ada_leaf(cfg.vid_dim, device, dtype), shared, vid_only)


class TimeEmbedding(nn.Module):
    def __init__(self, cfg: DiTConfig, device, dtype):
        super().__init__()
        D = cfg.vid_dim
        self.sinusoidal_dim = cfg.sinusoidal_dim
        self.proj_in = Linear(cfg.sinusoidal_dim, D, device, dtype)
        self.proj_hid = Linear(D, D, device, dtype)
        self.proj_out = Linear(D, cfg.emb_dim, device, dtype)

    def forward(self, timestep: torch.Tensor, dtype) -> torch.Tensor:
        """Sinusoid [sin | cos] (diffusers layout) + SiLU MLP -> [B, 6D]."""
        half = self.sinusoidal_dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=timestep.device) / half)
        ang = timestep.float()[:, None] * freqs[None]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
        emb = F.silu(self.proj_in(emb).float()).to(dtype)
        emb = F.silu(self.proj_hid(emb).float()).to(dtype)
        return self.proj_out(emb)


def _ada(p_ada: nn.ModuleDict, stream: str, x, emb_slices, idx: int, mode: str, prefix: Optional[str] = None):
    """AdaSingle: in: x * (scaleA + scaleB) + (shiftA + shiftB); out: x * (gateA + gateB)."""
    p = branch(p_ada, stream)
    prefix = prefix or ("attn", "mlp")[idx]
    e = emb_slices[:, :, idx, :]  # [B, D, 3]
    dt = x.dtype
    if mode == "in":
        scale = e[..., 1][:, None].to(dt) + getattr(p, f"{prefix}_scale")
        shift = e[..., 0][:, None].to(dt) + getattr(p, f"{prefix}_shift")
        return x * scale + shift
    g = e[..., 2][:, None].to(dt)
    if f"{prefix}_gate" in p.spec:
        g = g + getattr(p, f"{prefix}_gate")
    return x * g


def int8_linears(cfg: DiTConfig) -> frozenset:
    """The block linears that ops/quant.py:quantize_dit_params stores as
    int8 (``quant.quantizes`` on each whole weight), by path: NaDiT's
    ``int8`` for quantize="int8"."""
    dense = NaDiT(cfg, "meta", torch.float32)
    return frozenset(p[: -len("/w")] for p, m, leaf in leaf_paths(dense) if quant.quantizes(p, m.spec[leaf][0]))


class NaDiT(nn.Module):
    """``tensor`` > 1: the module holds one tensor rank's part of the
    weights (parallel/sharding.py) and runs only under ``sharded_dit`` with
    a tensor axis of that size.

    ``int8``: the block linears ("blocks/0/attn/qkv/vid", ...) held as int8
    weights (ops/quant.py): ``int8_linears(cfg)`` for quantize="int8", or
    the linears whose ``w_q`` a flat dict holds (io/weights.py); patch
    in/out and the embeddings stay in ``dtype``."""

    def __init__(self, cfg: DiTConfig, device=None, dtype=torch.bfloat16, attention_mode: str = "fused",
                 tensor: int = 1, int8: Collection[str] = ()):
        super().__init__()
        check_tensor_split(cfg, tensor)
        self.cfg = cfg
        self.tensor = tensor
        self.quantize = "int8" if int8 else None
        self.heads_local = cfg.heads // tensor
        self.set_attention_mode(attention_mode)
        D = cfg.vid_dim
        patch = int(np.prod(cfg.patch_size))
        self.vid_in = Linear(cfg.vid_in_channels * patch, D, device, dtype)
        self.txt_in = Linear(cfg.txt_in_dim, cfg.txt_dim, device, dtype)
        self.emb_in = TimeEmbedding(cfg, device, dtype)
        self.vid_out = Linear(D, cfg.vid_out_channels * patch, device, dtype)
        if cfg.vid_out_norm:
            self.vid_out_norm = Leaf({"w": ((D,), (ONES, 0.0))}, device, dtype)
            self.vid_out_ada = nn.ModuleDict(
                {"vid": _ada_leaf(D, device, dtype, layers=("out",), modes=("in",))}
            )
        int8 = frozenset(int8)
        self.blocks = nn.ModuleList([Block(cfg, i, device, dtype, tensor, int8) for i in range(cfg.num_layers)])
        unknown = int8 - {p[: -len("/w_q")] for p, _, _ in leaf_paths(self) if p.endswith("/w_q")}
        if unknown:
            raise ValueError(f"int8: no block linear at {sorted(unknown)[:3]}")

    def set_attention_mode(self, name: str) -> "NaDiT":
        """A name of ops/attention.py's alias table (fused, sdpa,
        flash_attn_2/3, sageattn_2/3, ...); unknown names raise. Returns the
        module, as ``eval()`` does."""
        self.attention_backend = resolve_attention_mode(name)
        return self

    # ------------------------------------------------------------------ #

    @staticmethod
    def _qkv_tokens(leaf: Linear, x):  # -> [B, len, 3 * heads_local * hd]
        return leaf(x)

    @staticmethod
    def _seq(h: Optional[ShardingHints]):
        return (h.seq_rank, h.seq_size, h.seq_group) if h is not None else (0, 1, None)

    @staticmethod
    def _gather_tokens(y, h: Optional[ShardingHints], chunk: int):
        """[B, Lloc, C] -> [B, seq * chunk, C]: every rank's token slice, the
        last one zero-padded (indices past L are never read)."""
        if h is None or h.seq_size == 1:
            return y
        return all_gather_cat(pad_to(y, 1, chunk), h.seq_group, dim=1)

    @staticmethod
    def _local_index(dp: DevicePlan, first: int, end: int, per: int) -> torch.Tensor:
        """Token indices of windows [first, end), then (per - (end - first))
        all-invalid padding windows that read token 0."""
        mL = dp.valid.shape[1]
        idx = dp.index[first * mL : end * mL]
        return idx if end - first == per else torch.cat([idx, idx.new_zeros((per - (end - first)) * mL)])

    def _window_attention_fused(self, attn: Attention, vid, txt, dp: DevicePlan, h: Optional[ShardingHints] = None):
        """K3 / K3q on head-major q, k, v. Sharded (``h``): this rank's
        token slice of qkv is all-gathered over seq, its windows gathered
        and attended by K3s, the window outputs all-gathered and its tokens
        taken back; the text outputs are summed in fp32 over its real
        windows, summed over seq and divided by nW (the mean over the
        unpadded windows); out-proj is row-parallel over tensor."""
        cfg = self.cfg
        B = vid.shape[0]
        H, hd = self.heads_local, cfg.head_dim

        def head_major(y):  # [B, len, 3*H*hd] -> [B, 3, H, len, hd]
            return y.reshape(y.shape[0], y.shape[1], 3, H, hd).permute(0, 2, 3, 1, 4)

        norms = torch.stack(
            [branch(attn.norm_q, "vid").w, branch(attn.norm_k, "vid").w,
             branch(attn.norm_q, "txt").w, branch(attn.norm_k, "txt").w]
        ).float()
        nW, mL = dp.valid.shape
        txt_qkv = head_major(self._qkv_tokens(branch(attn.qkv, "txt"), txt)).contiguous()
        vqkv = self._qkv_tokens(branch(attn.qkv, "vid"), vid)
        quant = self.attention_backend == "fused_int8"
        tables = (dp.vid_cos, dp.vid_sin, dp.txt_cos, dp.txt_sin, dp.valid, dp.rope_txt, norms, cfg.qk_norm,
                  cfg.norm_eps)
        if h is None:
            vid_win = head_major(vqkv).index_select(3, dp.index).reshape(B, 3, H, nW, mL, hd)
            ovid, otxt = fused_window_attention(vid_win, txt_qkv, *tables, quant_qk=quant)
            vid_tok = ovid.reshape(B, H, nW * mL, hd).index_select(2, dp.inverse)  # [B, H, L, hd]
            txt_tok = otxt.float().mean(dim=2).to(otxt.dtype)  # text outputs averaged over windows
        else:
            rank, size, group = self._seq(h)
            t0, t1, chunk = h.token_range(dp.inverse.numel())
            first, end, per = window_range(nW, size, rank)
            vqkv = self._gather_tokens(vqkv, h, chunk)
            vid_win = head_major(vqkv).index_select(3, self._local_index(dp, first, end, per))
            ovid, otxt = fused_window_attention_sharded(vid_win.reshape(B, 3, H, per, mL, hd), txt_qkv, *tables,
                                                        quant_qk=quant, seq_rank=rank, seq_size=size)
            ovid = all_gather_cat(ovid, group, dim=2)  # [B, H, size * per, mL, hd]: window w at position w
            vid_tok = ovid.reshape(B, H, -1, hd).index_select(2, dp.inverse[t0:t1])
            txt_tok = (all_reduce_sum(otxt[:, :, : end - first].float().sum(dim=2), group) / nW).to(otxt.dtype)

        def out_proj(lin, x_hm):
            return _row_linear(lin, x_hm.permute(0, 2, 1, 3).reshape(x_hm.shape[0], x_hm.shape[2], H * hd), h)

        return out_proj(branch(attn.out, "vid"), vid_tok), out_proj(branch(attn.out, "txt"), txt_tok)

    def _window_attention_unfused(self, attn: Attention, vid, txt, dp: DevicePlan, h: Optional[ShardingHints] = None):
        """Token-major path: projection, window gather, rms-norm and RoPE
        outside the attention; text appended to every window; keys valid =
        [window validity | all text]; K5 ("pallas") or the plain attention
        ("xla"); inverse gather and the text mean over windows. Sharded
        (``h``): B * windows over seq and heads over tensor, as the JAX
        package's constrain_attn_io shards them, with the gathers of the
        fused path."""
        cfg = self.cfg
        B = vid.shape[0]
        Lt = txt.shape[1]
        H, hd = self.heads_local, cfg.head_dim
        nW, mL = dp.valid.shape
        rank, size, group = self._seq(h)
        first, end, per = window_range(nW, size, rank)
        cos, sin, valid = shard_window_tables(dp.vid_cos, dp.vid_sin, dp.valid, rank, size)
        y = self._qkv_tokens(branch(attn.qkv, "vid"), vid)
        if h is None:
            index, inverse = dp.index, dp.inverse
        else:
            t0, t1, chunk = h.token_range(dp.inverse.numel())
            y = self._gather_tokens(y, h, chunk)
            index, inverse = self._local_index(dp, first, end, per), dp.inverse[t0:t1]
        vq, vk, vv = y.reshape(B, -1, 3, H, hd).index_select(1, index).reshape(B, per, mL, 3, H, hd).unbind(3)
        tq, tk, tv = self._qkv_tokens(branch(attn.qkv, "txt"), txt).reshape(B, Lt, 3, H, hd).unbind(2)
        if cfg.qk_norm:
            vq = rms_norm(vq, branch(attn.norm_q, "vid").w, cfg.norm_eps)
            vk = rms_norm(vk, branch(attn.norm_k, "vid").w, cfg.norm_eps)
            tq = rms_norm(tq, branch(attn.norm_q, "txt").w, cfg.norm_eps)
            tk = rms_norm(tk, branch(attn.norm_k, "txt").w, cfg.norm_eps)
        cos, sin = cos[None, :, :, None], sin[None, :, :, None]  # [1, per, mL, 1, hd]
        vq, vk = rotate(vq, cos, sin).to(vq.dtype), rotate(vk, cos, sin).to(vk.dtype)
        if dp.rope_txt:
            tcos, tsin = dp.txt_cos[None, :, None], dp.txt_sin[None, :, None]  # [1, Lt, 1, hd]
            tq, tk = rotate(tq, tcos, tsin).to(tq.dtype), rotate(tk, tcos, tsin).to(tk.dtype)

        def with_txt(vw, tw):  # [B, per, mL, H, hd] + [B, Lt, H, hd] -> [B*per, mL+Lt, H, hd]
            return torch.cat([vw, tw[:, None].expand(B, per, Lt, H, hd)], dim=2).reshape(B * per, mL + Lt, H, hd)

        kv_valid = torch.cat([valid, torch.ones((per, Lt), dtype=torch.bool, device=valid.device)], dim=1)
        kv_valid = kv_valid[None].expand(B, per, mL + Lt).reshape(B * per, mL + Lt)
        out = attention(with_txt(vq, tq), with_txt(vk, tk), with_txt(vv, tv), kv_valid, backend=self.attention_backend)
        out = out.reshape(B, per, mL + Lt, H * hd)
        if h is None:
            vid_out = out[:, :, :mL].reshape(B, nW * mL, H * hd).index_select(1, inverse)
            txt_out = out[:, :, mL:].float().mean(dim=1).to(out.dtype)  # text outputs averaged over windows
        else:
            vid_w = all_gather_cat(out[:, :, :mL], group, dim=1)  # [B, size * per, mL, H*hd]
            vid_out = vid_w.reshape(B, -1, H * hd).index_select(1, inverse)
            txt_out = (all_reduce_sum(out[:, : end - first, mL:].float().sum(dim=1), group) / nW).to(out.dtype)
        return _row_linear(branch(attn.out, "vid"), vid_out, h), _row_linear(branch(attn.out, "txt"), txt_out, h)

    def _block(self, blk: Block, vid, txt, emb_slices, dp: DevicePlan, h: Optional[ShardingHints] = None):
        eps = self.cfg.norm_eps
        vid_a = _ada(blk.ada, "vid", rms_norm(vid, None, eps), emb_slices, 0, "in")
        txt_a = rms_norm(txt, None, eps)
        if not blk.vid_only:
            txt_a = _ada(blk.ada, "txt", txt_a, emb_slices, 0, "in")
        if self.attention_backend in ("fused", "fused_int8"):
            vid_a, txt_a = self._window_attention_fused(blk.attn, vid_a, txt_a, dp, h)
        else:
            vid_a, txt_a = self._window_attention_unfused(blk.attn, vid_a, txt_a, dp, h)
        vid = vid + _ada(blk.ada, "vid", vid_a, emb_slices, 0, "out")
        txt = txt + (txt_a if blk.vid_only else _ada(blk.ada, "txt", txt_a, emb_slices, 0, "out"))

        vid_m = _ada(blk.ada, "vid", rms_norm(vid, None, eps), emb_slices, 1, "in")
        vid = vid + _ada(blk.ada, "vid", branch(blk.mlp, "vid")(vid_m, h), emb_slices, 1, "out")
        if not blk.vid_only:
            txt_m = _ada(blk.ada, "txt", rms_norm(txt, None, eps), emb_slices, 1, "in")
            txt = txt + _ada(blk.ada, "txt", branch(blk.mlp, "txt")(txt_m, h), emb_slices, 1, "out")
        return vid, txt

    def forward(
        self,
        vid: torch.Tensor,  # [B, T, H, W, vid_in_channels]
        txt: torch.Tensor,  # [B, Lt, txt_in_dim]
        timestep: torch.Tensor,  # [B]
        dplans: Tuple[DevicePlan, DevicePlan],  # (plain, shifted) for the patched shape
    ) -> torch.Tensor:
        """Returns [B, T, H, W, vid_out_channels]. Under ``sharded_dit`` every
        rank returns the whole output (its token slices all-gathered)."""
        cfg = self.cfg
        h = current_hints()
        if h is not None and h.seq_size == 1 and h.tensor_size == 1:
            h = None
        if (h.tensor_size if h is not None else 1) != self.tensor:
            raise RuntimeError(f"the DiT's weights are split over {self.tensor} tensor rank(s) but the forward runs "
                               f"with tensor={h.tensor_size if h is not None else 1}")
        B, T, H, W, C = vid.shape
        pt, ph, pw = cfg.patch_size
        if pt != 1:
            raise NotImplementedError("temporal patch > 1")
        Hp, Wp = H // ph, W // pw
        L = T * Hp * Wp
        x = vid.reshape(B, T, Hp, ph, Wp, pw, C).permute(0, 1, 2, 4, 3, 5, 6).reshape(B, L, ph * pw * C)
        if h is not None:  # this rank's token slice
            t0, t1, chunk = h.token_range(L)
            x = x[:, t0:t1]
        x = self.vid_in(x)
        t_emb = self.txt_in(txt)
        emb_slices = self.emb_in(timestep, x.dtype).reshape(B, cfg.vid_dim, 2, 3)
        for i, blk in enumerate(self.blocks):  # window plans alternate plain, shifted
            x, t_emb = self._block(blk, x, t_emb, emb_slices, dplans[i % 2], h)
        if cfg.vid_out_norm:
            x = rms_norm(x, self.vid_out_norm.w, cfg.norm_eps)
            x = _ada(self.vid_out_ada, "vid", x, emb_slices, 0, "in", prefix="out")
        x = self.vid_out(x)
        if h is not None:
            x = self._gather_tokens(x, h, chunk)[:, :L]
        x = x.reshape(B, T, Hp, Wp, ph, pw, cfg.vid_out_channels)
        return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, H, W, cfg.vid_out_channels)
