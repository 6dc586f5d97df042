"""The work of the program's layers, worked out from the configuration and
the shapes of each call: floating-point operations (a multiply-add is 2)
and the bytes that the work needs to move at the least (each input and
weight byte read once, each output byte written once, bf16 activations and
weights). The benchmark's own count: nothing here is read from the
program.

A roofline share is ``least_s`` over the measured device time: the larger
of ops / peak FLOP/s and bytes / peak bytes/s. The peaks are NVIDIA's
data-sheet figures for one H100 SXM (dense bf16, HBM3), at its full power
limit of 700 W.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple, Sequence, Tuple

from .reference.dit import mlp_hidden, window_cuts

PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12  # HBM bytes/s
ACT = 2  # bytes of a bf16 activation or weight


class Work(NamedTuple):
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)


def total(works: Sequence[Work]) -> Work:
    out = Work()
    for w in works:
        out = out + w
    return out


# ------------------------------- the VAE ---------------------------------- #


def conv3d(x_shape: Tuple[int, ...], kernel: Tuple[int, int, int], cout: int, stride: Tuple[int, int, int],
           spatial_pad, t_ext: int) -> Work:
    """A causal conv of x [B, T, H, W, Cin] whose time axis is extended to
    ``t_ext`` frames (the head repeated, or a carry), padded in space by
    ((top, bottom), (left, right))."""
    B, T, H, W, cin = x_shape
    kt, kh, kw = kernel
    (ht, hb), (wl, wr) = spatial_pad
    to = (t_ext - kt) // stride[0] + 1
    ho = (H + ht + hb - kh) // stride[1] + 1
    wo = (W + wl + wr - kw) // stride[2] + 1
    out = B * to * ho * wo * cout
    return Work(2.0 * out * cin * kt * kh * kw, ACT * (B * T * H * W * cin + kt * kh * kw * cin * cout + out))


def upsample(x_shape: Tuple[int, ...], temporal_up: bool, streaming: bool = False) -> Work:
    """The decoder's 2x upsample (1x1x1 expansion, depth to space, 3x3x3
    causal conv) counted as the single low-resolution conv it composes
    to: each output pixel takes 2 x 2 spatial taps of the low-resolution
    input and, in time, 2 taps (a time upsample; the first output frame of
    a clip, whose head repeats frame 0, takes 1) or 3 taps (no time
    upsample); weights as the checkpoint holds them."""
    B, T, H, W, C = x_shape
    if temporal_up:
        taps = [2] * (2 * T) if streaming else [1] + [2] * (2 * T - 2)
        ratio = 8
    else:
        taps = [3] * T
        ratio = 4
    out_px = B * len(taps) * 4 * H * W
    flops = 2.0 * B * sum(taps) * 4 * H * W * C * C * 4
    return Work(flops, ACT * (B * T * H * W * C + (27 + ratio) * C * C + out_px * C))


def mid_attention(x_shape: Tuple[int, ...]) -> Work:
    """Per-frame single-head attention over all pixels of [B, T, H, W, C]:
    the q, k, v and out projections, Q K^T and P V."""
    B, T, H, W, C = x_shape
    n = H * W
    frames = B * T
    return Work(frames * (4 * 2.0 * n * C * C + 4.0 * n * n * C), ACT * frames * (2 * n * C + 4 * C * C))


# ------------------------------- the DiT ---------------------------------- #


def window_lengths(thw: Tuple[int, int, int], num_windows: Sequence[int], shifted: bool):
    """The token count of every attention window of a patched latent (t,
    h, w) (the reference's windows: the 720p window cut ``num_windows``
    ways, aligned or shifted by half a window)."""
    return [(t1 - t0) * (h1 - h0) * (w1 - w0)
            for (t0, t1), (h0, h1), (w0, w1) in window_cuts(thw, num_windows, shifted)]


def window_attention(dit: dict, thw: Tuple[int, int, int], txt_len: int, batch: int, shifted: bool) -> Work:
    """One layer's attention: in every window, Q K^T and P V over its real
    video tokens and the whole text (queries and keys alike); q, k, v of
    the video and of the text read once, the video's and the text's outputs
    written once."""
    inner = dit["heads"] * dit["head_dim"]
    flops = sum(4.0 * (n + txt_len) ** 2 * inner for n in window_lengths(thw, dit["window"], shifted))
    L = thw[0] * thw[1] * thw[2]
    return Work(batch * flops, ACT * batch * 4 * (L + txt_len) * inner)


def dit_linears(dit: dict, tokens: int, txt_len: int, batch: int) -> Work:
    """Every linear of one forward: patch in and out, text in, the time
    embedding, and in each layer qkv, out, and the MLP of the video and
    (where the layer has a text MLP) of the text. Bytes: each weight once,
    each activation in and out once."""
    D, inner, hid = dit["vid_dim"], dit["heads"] * dit["head_dim"], mlp_hidden(SimpleNamespace(**dit))
    patch = math.prod(dit["patch_size"])
    n_mlp = 3 if dit["mlp_type"] == "swiglu" else 2
    flops = weights = acts = 0.0

    def lin(rows, din, dout):
        nonlocal flops, weights, acts
        flops += 2.0 * rows * din * dout
        weights += din * dout
        acts += rows * (din + dout)

    lin(tokens, dit["vid_in_channels"] * patch, D)
    lin(txt_len, dit["txt_in_dim"], dit["txt_dim"])
    lin(1, dit["sinusoidal_dim"], D)
    lin(1, D, D)
    lin(1, D, dit["emb_dim"])
    for i in range(dit["num_layers"]):
        vid_only = dit["last_layer_vid_only"] and i == dit["num_layers"] - 1
        for rows, mlp in ((tokens, True), (txt_len, not vid_only)):
            lin(rows, D, 3 * inner)
            lin(rows, inner, D)
            if mlp:
                for _ in range(n_mlp - 1):
                    lin(rows, D, hid)
                lin(rows, hid, D)
    lin(tokens, D, dit["vid_out_channels"] * patch)
    return Work(batch * flops, ACT * (weights + batch * acts))


def dit_forward(dit: dict, latent_thw: Tuple[int, int, int], txt_len: int, batch: int):
    """(linears, [attention of each layer]) of one DiT forward on a latent
    (t, h, w); layers alternate aligned and shifted windows."""
    pt, ph, pw = dit["patch_size"]
    thw = (latent_thw[0] // pt, latent_thw[1] // ph, latent_thw[2] // pw)
    attn = [window_attention(dit, thw, txt_len, batch, i % 2 == 1) for i in range(dit["num_layers"])]
    return dit_linears(dit, thw[0] * thw[1] * thw[2], txt_len, batch), attn
