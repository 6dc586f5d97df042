"""NaDiT-3B / NaDiT-7B in plain PyTorch, float32, on the published
checkpoint's keys and layouts (``spec``): the architecture of
configs_3b/main.yaml and configs_7b/main.yaml as the configuration file
states it.

One forward: patchify, vid_in, txt_in, the sinusoidal time embedding, then
``num_layers`` blocks of AdaLN-single modulated attention and MLP over the
video and text streams, then (3B) an output RMS norm with its own
modulation, vid_out and unpatchify. Layers from ``mm_layers`` on share one
set of weights for both streams; 3B's last layer is video-only.

Attention runs in 3D windows whose size in tokens is set as at 720p
(``window_cuts``), alternately aligned and shifted by half a window. Every
window holds its video tokens and the whole text; queries and keys are
RMS-normed per head, then rotated (mmrope3d: positions inside the window,
time offset by the text length, and the text at its own index on every
axis; window_pixel: linspace(-1, 1) positions inside the window, text not
rotated). Each video token takes its window's output; the text takes the
mean of its outputs over all windows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics
from .vae import BIAS_STD, NORM_STD

ADA = ("attn_shift", "attn_scale", "attn_gate", "mlp_shift", "mlp_scale", "mlp_gate")


# --------------------------------------------------------------------------- #
# Published layout and the random weights' distributions
# --------------------------------------------------------------------------- #


def mlp_hidden(cfg) -> int:
    if cfg.mlp_type == "swiglu":
        m = cfg.swiglu_multiple_of
        return m * ((int(2 * cfg.vid_dim * cfg.expand_ratio / 3) + m - 1) // m)
    return cfg.vid_dim * cfg.expand_ratio


def branches(cfg, layer: int) -> Tuple[str, ...]:
    if layer >= cfg.mm_layers:
        return ("all",)
    return ("vid",) if (cfg.last_layer_vid_only and layer == cfg.num_layers - 1) else ("vid", "txt")


def spec(cfg) -> List[Tuple[str, tuple, str, float]]:
    """(key, shape, init, scale) of every tensor of the checkpoint, in file
    order. init: "normal" (N(0, scale^2)), "1+normal" (1 + N(0, scale^2)):
    every bias and norm weight away from its trivial value, as the VAE's
    (vae.py:BIAS_STD, NORM_STD)."""
    D, inner, hd = cfg.vid_dim, cfg.heads * cfg.head_dim, cfg.head_dim
    patch = int(np.prod(cfg.patch_size))
    out = []

    def lin(key, dout, din, bias=True):
        out.append((f"{key}.weight", (dout, din), "normal", din**-0.5))
        if bias:
            out.append((f"{key}.bias", (dout,), "normal", BIAS_STD))

    lin("vid_in.proj", D, cfg.vid_in_channels * patch)
    lin("txt_in", cfg.txt_dim, cfg.txt_in_dim)
    lin("emb_in.proj_in", D, cfg.sinusoidal_dim)
    lin("emb_in.proj_hid", D, D)
    lin("emb_in.proj_out", cfg.emb_dim, D)
    for i in range(cfg.num_layers):
        p = f"blocks.{i}"
        for br in branches(cfg, i):
            lin(f"{p}.attn.proj_qkv.{br}", 3 * inner, D, bias=cfg.qk_bias)
            lin(f"{p}.attn.proj_out.{br}", D, inner)
            out.append((f"{p}.attn.norm_q.{br}.weight", (hd,), "1+normal", NORM_STD))
            out.append((f"{p}.attn.norm_k.{br}.weight", (hd,), "1+normal", NORM_STD))
            hid = mlp_hidden(cfg)
            if cfg.mlp_type == "swiglu":
                lin(f"{p}.mlp.{br}.proj_in_gate", hid, D, bias=False)
                lin(f"{p}.mlp.{br}.proj_in", hid, D, bias=False)
                lin(f"{p}.mlp.{br}.proj_out", D, hid, bias=False)
            else:
                lin(f"{p}.mlp.{br}.proj_in", hid, D)
                lin(f"{p}.mlp.{br}.proj_out", D, hid)
            for a in ADA:
                out.append((f"{p}.ada.{br}.{a}", (D,), "1+normal" if a.endswith("scale") else "normal", D**-0.5))
    if cfg.vid_out_norm:
        out.append(("vid_out_norm.weight", (D,), "1+normal", NORM_STD))
        out.append(("vid_out_ada.out_shift", (D,), "normal", D**-0.5))
        out.append(("vid_out_ada.out_scale", (D,), "1+normal", D**-0.5))
    lin("vid_out.proj", cfg.vid_out_channels * patch, D)
    return out


# --------------------------------------------------------------------------- #
# Windows and rotary angles
# --------------------------------------------------------------------------- #


def _axis_cuts(extent: int, win: int, shifted: bool) -> List[Tuple[int, int]]:
    if win >= extent:
        return [(0, extent)]
    if not shifted:
        return [(lo, min(lo + win, extent)) for lo in range(0, extent, win)]
    cuts, hi, i = [], 0, 0
    while hi < extent:
        lo, hi = hi, min(int((i + 0.5) * win), extent)
        i += 1
        if hi > lo:
            cuts.append((lo, hi))
    return cuts


def window_cuts(thw: Tuple[int, int, int], num_windows, shifted: bool):
    """The windows of a patched latent (t, h, w): ((t0, t1), (h0, h1), (w0,
    w1)) each. The window size is the 720p frame's (45 x 80 patches) cut
    ``num_windows`` ways, so a larger frame holds more windows."""
    t, h, w = thw
    scale = math.sqrt((45 * 80) / (h * w))
    wt = math.ceil(min(t, 30) / num_windows[0])
    wh = math.ceil(round(h * scale) / num_windows[1])
    ww = math.ceil(round(w * scale) / num_windows[2])
    return [(ct, ch, cw) for cw in _axis_cuts(w, ww, shifted) for ch in _axis_cuts(h, wh, shifted)
            for ct in _axis_cuts(t, wt, shifted)]


def _axial_angles(dims, freqs: np.ndarray, positions) -> np.ndarray:
    """[prod(dims), len(dims) * len(freqs)] angles, float64."""
    grids = np.meshgrid(*[positions(d) for d in dims], indexing="ij")
    return np.concatenate([g.reshape(-1, 1) * freqs[None] for g in grids], axis=1)


def rope_angles(cfg, shape: Tuple[int, int, int], txt_len: int):
    """(video angles [t*h*w, head_dim], text angles [txt_len, head_dim] or
    None) of one window, zero past the rotated channels."""
    per = (cfg.rope_dim // 3) & ~1
    if cfg.rope_type == "mmrope3d":
        freqs = np.repeat(1.0 / (10000.0 ** (np.arange(0, per, 2, dtype=np.float64) / per)), 2)
        grids = list(np.meshgrid(*[np.arange(d, dtype=np.float64) for d in shape], indexing="ij"))
        grids[0] = grids[0] + txt_len
        vid = np.concatenate([g.reshape(-1, 1) * freqs[None] for g in grids], axis=1)
        pos = np.arange(txt_len, dtype=np.float64)[:, None]
        txt = np.concatenate([pos * freqs[None]] * 3, axis=1)
    elif cfg.rope_type == "window_pixel":
        freqs = np.repeat(np.linspace(1.0, 128.0, per // 2, dtype=np.float64) * np.pi, 2)
        vid = _axial_angles(shape, freqs, lambda d: np.linspace(-1.0, 1.0, d) if d > 1 else np.array([-1.0]))
        txt = None
    else:
        raise NotImplementedError(cfg.rope_type)

    def pad(a):
        return None if a is None else np.pad(a, ((0, 0), (0, cfg.head_dim - a.shape[1])))

    return pad(vid), pad(txt)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Pairwise rotation of channels (2i, 2i+1)."""
    x2 = x.unflatten(-1, (x.shape[-1] // 2, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)
    return x * cos + rot * sin


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #


def rms(x: torch.Tensor, eps: float, w=None) -> torch.Tensor:
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return y if w is None else y * w.float()


class DiT:
    """``sd``: the checkpoint's tensors by published key (any float type;
    read in float32 when used)."""

    def __init__(self, cfg, sd: Dict[str, torch.Tensor], num: Numerics):
        self.cfg, self.sd, self.num = cfg, sd, num
        self._angles: Dict[tuple, tuple] = {}

    def w(self, key):
        return self.sd[key].float()

    def lin(self, key, x, bias=True):
        b = self.sd.get(f"{key}.bias") if bias else None
        return self.num.linear(x, self.sd[f"{key}.weight"], b)

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        half = self.cfg.sinusoidal_dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64, device=t.device) / half)
        ang = t.double()[:, None] * freqs[None]
        e = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()
        e = F.silu(self.lin("emb_in.proj_in", e))
        e = F.silu(self.lin("emb_in.proj_hid", e))
        return self.lin("emb_in.proj_out", e)

    def attention(self, i: int, x: torch.Tensor, txt: torch.Tensor, thw, shifted: bool):
        cfg, num = self.cfg, self.num
        B, L, _ = x.shape
        Lt = txt.shape[1]
        H, hd = cfg.heads, cfg.head_dim
        bv, bt = ("all", "all") if i >= cfg.mm_layers else ("vid", "txt")
        p = f"blocks.{i}.attn"
        qkv = self.lin(f"{p}.proj_qkv.{bv}", x, cfg.qk_bias).reshape(B, L, 3, H, hd)
        tqkv = self.lin(f"{p}.proj_qkv.{bt}", txt, cfg.qk_bias).reshape(B, Lt, 3, H, hd)
        q, k, v = qkv.unbind(2)
        tq, tk, tv = tqkv.unbind(2)
        if cfg.qk_norm:
            q, k = rms(q, cfg.norm_eps, self.w(f"{p}.norm_q.{bv}.weight")), rms(k, cfg.norm_eps,
                                                                               self.w(f"{p}.norm_k.{bv}.weight"))
            tq, tk = rms(tq, cfg.norm_eps, self.w(f"{p}.norm_q.{bt}.weight")), rms(tk, cfg.norm_eps,
                                                                                  self.w(f"{p}.norm_k.{bt}.weight"))
        t, h, w = thw
        grid = torch.arange(L, device=x.device).reshape(t, h, w)
        wins = window_cuts(thw, cfg.window, shifted)
        idx = [grid[a0:a1, b0:b1, c0:c1].reshape(-1) for (a0, a1), (b0, b1), (c0, c1) in wins]
        shapes = [(a1 - a0, b1 - b0, c1 - c0) for (a0, a1), (b0, b1), (c0, c1) in wins]
        out_vid = torch.empty((B, L, H, hd), dtype=torch.float32, device=x.device)
        txt_sum = torch.zeros((B, Lt, H, hd), dtype=torch.float64, device=x.device)
        scale = 1.0 / math.sqrt(hd)
        for ids, shape in zip(idx, shapes):
            (cv, sv), txt_rope = self.cos_sin(shape, Lt, x.device)
            qw, kw = rotate(q[:, ids], cv, sv), rotate(k[:, ids], cv, sv)  # [B, n, H, hd]
            tqw, tkw = (tq, tk) if txt_rope is None else (rotate(tq, *txt_rope), rotate(tk, *txt_rope))
            qs = torch.cat([qw, tqw], 1).transpose(1, 2)  # [B, H, n + Lt, hd]
            ks = torch.cat([kw, tkw], 1).transpose(1, 2)
            vs = torch.cat([v[:, ids], tv], 1).transpose(1, 2)
            probs = torch.softmax(num.matmul(qs, ks.transpose(-1, -2)) * scale, dim=-1)
            o = num.matmul(probs, vs).transpose(1, 2)  # [B, n + Lt, H, hd]
            out_vid[:, ids] = o[:, : len(ids)]
            txt_sum += o[:, len(ids):].double()
        ov = out_vid.reshape(B, L, H * hd)
        ot = (txt_sum / len(wins)).float().reshape(B, Lt, H * hd)
        return self.lin(f"{p}.proj_out.{bv}", ov), self.lin(f"{p}.proj_out.{bt}", ot)

    def cos_sin(self, shape, txt_len: int, device):
        """(cos, sin) of a window's video tokens and of the text (or None),
        [1, n, 1, head_dim] float32, computed once a window shape."""
        key = (shape, txt_len)
        if key not in self._angles:
            def cs(a):
                a = torch.from_numpy(a)[None, :, None]
                return torch.cos(a).float().to(device), torch.sin(a).float().to(device)

            vang, tang = rope_angles(self.cfg, shape, txt_len)
            self._angles[key] = (cs(vang), None if tang is None else cs(tang))
        return self._angles[key]

    def mlp(self, i: int, br: str, x: torch.Tensor) -> torch.Tensor:
        p = f"blocks.{i}.mlp.{br}"
        if self.cfg.mlp_type == "swiglu":
            h = F.silu(self.lin(f"{p}.proj_in_gate", x, False)) * self.lin(f"{p}.proj_in", x, False)
            return self.lin(f"{p}.proj_out", h, False)
        h = F.gelu(self.lin(f"{p}.proj_in", x), approximate="tanh")
        return self.lin(f"{p}.proj_out", h)

    def forward(self, vid: torch.Tensor, txt: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor:
        """vid [B, T, H, W, vid_in_channels], txt [B, Lt, txt_in_dim],
        timestep [B] -> [B, T, H, W, vid_out_channels], float32."""
        cfg = self.cfg
        eps = cfg.norm_eps
        B, T, Hh, Ww, C = vid.shape
        pt, ph, pw = cfg.patch_size
        Hp, Wp = Hh // ph, Ww // pw
        thw = (T // pt, Hp, Wp)
        x = vid.float().reshape(B, T, Hp, ph, Wp, pw, C).permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T * Hp * Wp, -1)
        x = self.lin("vid_in.proj", x)
        tx = self.lin("txt_in", txt.float())
        e = self.time_embedding(timestep).reshape(B, cfg.vid_dim, 2, 3)

        def mod(key, idx, k):  # the shift (k 0), scale (1) or gate (2) of the attention (idx 0) or MLP (1)
            return e[:, None, :, idx, k] + self.w(key)

        for i in range(cfg.num_layers):
            shared = i >= cfg.mm_layers
            vid_only = cfg.last_layer_vid_only and i == cfg.num_layers - 1
            bv, bt = ("all", "all") if shared else ("vid", "txt")
            a = f"blocks.{i}.ada"
            xa = rms(x, eps) * mod(f"{a}.{bv}.attn_scale", 0, 1) + mod(f"{a}.{bv}.attn_shift", 0, 0)
            ta = rms(tx, eps)
            if not vid_only:
                ta = ta * mod(f"{a}.{bt}.attn_scale", 0, 1) + mod(f"{a}.{bt}.attn_shift", 0, 0)
            ov, ot = self.attention(i, xa, ta, thw, shifted=i % 2 == 1)
            x = x + ov * mod(f"{a}.{bv}.attn_gate", 0, 2)
            tx = tx + (ot if vid_only else ot * mod(f"{a}.{bt}.attn_gate", 0, 2))
            xm = rms(x, eps) * mod(f"{a}.{bv}.mlp_scale", 1, 1) + mod(f"{a}.{bv}.mlp_shift", 1, 0)
            x = x + self.mlp(i, bv, xm) * mod(f"{a}.{bv}.mlp_gate", 1, 2)
            if not vid_only:
                tm = rms(tx, eps) * mod(f"{a}.{bt}.mlp_scale", 1, 1) + mod(f"{a}.{bt}.mlp_shift", 1, 0)
                tx = tx + self.mlp(i, bt, tm) * mod(f"{a}.{bt}.mlp_gate", 1, 2)
        if cfg.vid_out_norm:
            x = rms(x, eps, self.w("vid_out_norm.weight"))
            x = x * mod("vid_out_ada.out_scale", 0, 1) + mod("vid_out_ada.out_shift", 0, 0)
        x = self.lin("vid_out.proj", x)
        x = x.reshape(B, T, Hp, Wp, ph, pw, cfg.vid_out_channels).permute(0, 1, 2, 4, 3, 5, 6)
        return x.reshape(B, T, Hh, Ww, cfg.vid_out_channels)
