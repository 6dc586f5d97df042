"""The traffic kind ``phasedclips``: long clips whose batches overlap in
time and whose VAE passes are tiled in space, so that each request takes
the program's 4-phase route (encode every batch, one DiT step a batch,
decode every batch with the overlap blended, then the colour fix).

A mix file holds what a ``clips`` mix holds (traffic/clips.py), with
``pipeline`` setting ``temporal_overlap`` > 0 and, for tiling,
``encode_tiled`` / ``decode_tiled`` with their tile sizes and overlaps (in
pixels). The requests, their seeds and their inputs are drawn as
``clips.Mix`` draws them.

On this route ``phases.generate(..., packed=True)`` returns float32 frames
in [0, 1]; a frame's codes are floor(255 x + 1/2), as the reference makes
its own. The conversion is made after the window, on the compared units
alone.

The reference of a unit (frames [lo, hi) of a request) is the plain
float32 model (reference/) on the batches that cover those frames, each
batch computed tile by tile as the program documents its route
(SURVEY.md §3.5, the JAX package's pipeline/phases.py and
models/vae/tiling.py):

- batches: start at 0 and every ``batch - overlap`` frames, each
  ``batch`` frames long or cut at the clip's end (then padded to 4n + 1
  frames by time-reversed frames); a trailing batch that lies inside the
  overlap is dropped;
- one batch: the frames resized and padded as reference/pipeline.py
  does, encoded, one Euler step of the DiT with the request's seed (every
  batch draws the same noise), decoded;
- tiled encode: a tile grid in latent coordinates (tile and overlap in
  pixels over the downsampling factor; an overlap that floors to 0 on an
  axis that needs several tiles is taken as 128 px), equalised: the naive
  grid's tile count, each tile shrunk to the least size that covers the
  axis with that overlap, starts spread evenly and rounded. Each tile's
  moments are weighed by separable cosine ramps (0.5 - 0.5 cos(pi t), t
  from 0 to 1 with both ends) on its interior edges, the ramp clamped to
  the grid's smallest seam, and the weighted sum is divided by the summed
  weights;
- tiled decode: the same grid of the latent, the ramps in pixels (the
  pixel overlap clamped to the smallest pixel seam);
- overlap: the head of each batch after the first is blended into the
  previous output's tail with the previous weight 0.5 + 0.5 cos(pi u),
  u = clip((t - 1/3) / (1/3), 0, 1), t from 0 to 1 over the overlap (a
  Hann crossfade over its middle third; linear from 1 to 0 for an overlap
  under 3); the rest of the batch follows;
- then, frame by frame, the wavelet colour fix against the frame's own
  transformed input, and the codes.

Every batch is computed in float32, once a unit; a tile is encoded or
decoded whole (the reference VAE works a few output frames of a
convolution at a time).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from .clips import Mix as ClipsMix
from .clips import Request


def batch_ranges(total: int, batch: int, overlap: int) -> List[Tuple[int, int]]:
    """(start, end) of every batch of a clip of ``total`` frames."""
    step = batch - overlap if 0 < overlap < batch else batch
    overlap = overlap if 0 < overlap < batch else 0
    out = []
    for start in range(0, total, step):
        end = min(start + batch, total)
        if start and end - start <= overlap:
            break
        out.append((start, end))
    return out


def overlap_weights(overlap: int) -> np.ndarray:
    """The previous batch's weight over the overlap."""
    if overlap >= 3:
        t = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
        u = np.clip((t - 1.0 / 3.0) / (1.0 / 3.0), 0.0, 1.0)
        return (0.5 + 0.5 * np.cos(np.pi * u)).astype(np.float32)
    return np.linspace(1.0, 0.0, overlap, dtype=np.float32)


def frame_sources(total: int, batch: int, overlap: int) -> List[Dict[Tuple[int, int], float]]:
    """For each output frame, {(batch index, frame in the batch): weight}:
    the batches written in order, each one's head blended into what the
    output holds there."""
    out: List[Dict[Tuple[int, int], float]] = []
    w = overlap_weights(overlap) if overlap else None
    for k, (start, end) in enumerate(batch_ranges(total, batch, overlap)):
        frames = [{(k, j): 1.0} for j in range(end - start)]
        if k and 0 < overlap < len(frames) and len(out) >= overlap:
            for j in range(overlap):
                f = len(out) - overlap + j
                blended = {key: v * float(w[j]) for key, v in out[f].items()}
                blended[(k, j)] = blended.get((k, j), 0.0) + (1.0 - float(w[j]))
                out[f] = blended
            frames = frames[overlap:]
        out.extend(frames)
    return out


# ------------------------------ the tile grid ------------------------------ #


def cosine_ramp(n: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    return 0.5 - 0.5 * np.cos(t * np.pi)


def axis_grid(total: int, tile_max: int, overlap: int) -> Tuple[int, List[int]]:
    """(tile, starts) of one axis of the equalised grid."""
    if total <= tile_max:
        return total, [0]
    overlap = min(overlap, tile_max - 1)
    n = math.ceil((total - overlap) / (tile_max - overlap))
    tile = math.ceil((total + (n - 1) * overlap) / n)
    return tile, [round(i * (total - tile) / (n - 1)) for i in range(n)]


def seam_ramp(tile: int, starts: List[int], overlap: int) -> int:
    r = max(0, min(overlap, tile - 1))
    for a, b in zip(starts, starts[1:]):
        r = min(r, a + tile - b)
    return max(0, r)


def edge_weights(n: int, ramp: int, first: bool, last: bool) -> np.ndarray:
    w = np.ones(n, dtype=np.float32)
    ramp = max(0, min(ramp, n - 1))
    if ramp:
        r = cosine_ramp(ramp)
        if not first:
            w[:ramp] = r
        if not last:
            w[-ramp:] = 1.0 - r
    return w


def pixel_overlap(overlap: int, extent_lat: int, tile_lat: int, sf: int) -> int:
    """The hard-seam guard: a pixel overlap that floors to no latent overlap
    on an axis of several tiles is taken as 128 px."""
    return 128 if extent_lat > tile_lat and overlap // sf <= 0 else overlap


def encode_grid(extent_lat: int, tile_px: int, overlap_px: int, sf: int):
    """One axis of the encode grid: (latent tile, latent starts, latent ramp)."""
    tile_lat = max(1, tile_px // sf)
    lo = max(0, min(pixel_overlap(overlap_px, extent_lat, tile_lat, sf) // sf, tile_lat - 1))
    tile, starts = axis_grid(extent_lat, tile_lat, lo)
    return tile, starts, seam_ramp(tile, starts, lo)


def decode_grid(extent_lat: int, tile_px: int, overlap_px: int, sf: int):
    """One axis of the decode grid: (latent tile, latent starts, pixel ramp)."""
    tile_lat = max(1, tile_px // sf)
    ov = pixel_overlap(overlap_px, extent_lat, tile_lat, sf)
    tile, starts = axis_grid(extent_lat, tile_lat, max(0, min(ov // sf, tile_lat - 1)))
    return tile, starts, seam_ramp(tile * sf, [s * sf for s in starts], ov)


def blend_tiles(run, x, rows, cols, tile: Tuple[int, int], ramps: Tuple[int, int], scale: int, out_hw):
    """x [B, C, T, H, W]; ``run`` maps the input tile at latent (y, x) of
    size ``tile`` (inputs ``scale`` times the latent grid in space: 8 for
    an encode, 1 for a decode) to its output [B, C', T', th, tw]; the
    outputs blended into [B, C', T', *out_hw] by the ramps (in the
    output's own units)."""
    import torch

    acc = cnt = None
    (th, tw), (rh, rw) = tile, ramps
    for y in rows:
        for x0 in cols:
            out = run(x[..., y * scale : (y + th) * scale, x0 * scale : (x0 + tw) * scale])
            oh, ow = out.shape[-2:]
            w = np.outer(edge_weights(oh, rh, y == rows[0], y == rows[-1]),
                         edge_weights(ow, rw, x0 == cols[0], x0 == cols[-1]))
            w = torch.from_numpy(w).to(out.device)
            if acc is None:
                acc = out.new_zeros(out.shape[:3] + tuple(out_hw))
                cnt = out.new_zeros(tuple(out_hw))
            oy, ox = y * oh // th, x0 * ow // tw
            acc[..., oy : oy + oh, ox : ox + ow] += out * w
            cnt[oy : oy + oh, ox : ox + ow] += w
            del out
    return acc / cnt.clamp_min(1e-6)


# ------------------------------- the kind --------------------------------- #


class Mix(ClipsMix):
    def __init__(self, params: dict, seed: int):
        super().__init__(params, seed)
        p = params["pipeline"]
        self.overlap = int(p.get("temporal_overlap", 0))
        if not 0 < self.overlap < self.batch:
            raise ValueError("phasedclips: a temporal overlap between 0 and the batch size")

    @staticmethod
    def program_codes(out, lo: int, hi: int) -> np.ndarray:
        """Frames [lo, hi) of a request's float32 [0, 1] output as codes."""
        return np.floor(np.asarray(out[lo:hi], np.float32) * 255.0 + 0.5).astype(np.uint8)

    # -------------------------- the reference ---------------------------- #

    def _encode(self, ref, tv):
        """tv [1, 3, T, H, W] in [-1, 1] -> the posterior's mode, scaled."""
        import torch

        vc, p = ref.cfg.vae, self.params["pipeline"]
        sf = vc.spatial_downsample_factor
        H, W = tv.shape[-2:]
        size = tuple(p.get("encode_tile_size", (1024, 1024)))
        if not p.get("encode_tiled") or (H <= size[0] and W <= size[1]):
            moments = ref.vae.encode(tv)
        else:
            h_lat, w_lat = -(-H // sf), -(-W // sf)
            if (h_lat * sf, w_lat * sf) != (H, W):  # the last row and column repeated to the latent grid
                tv = torch.cat([tv, tv[..., -1:, :].expand(*tv.shape[:3], h_lat * sf - H, W)], dim=-2)
                tv = torch.cat([tv, tv[..., -1:].expand(*tv.shape[:4], w_lat * sf - W)], dim=-1)
            ov = tuple(p.get("encode_tile_overlap", (128, 128)))
            th, rows, rh = encode_grid(h_lat, size[0], ov[0], sf)
            tw, cols, rw = encode_grid(w_lat, size[1], ov[1], sf)
            moments = blend_tiles(ref.vae.encode, tv, rows, cols, (th, tw), (rh, rw), sf, (h_lat, w_lat))
        return (moments[:, : vc.latent_channels] - vc.shifting_factor) * vc.scaling_factor

    def _decode(self, ref, z):
        """z [1, C, t, h, w] (unscaled) -> [1, 3, T, 8h, 8w]."""
        vc, p = ref.cfg.vae, self.params["pipeline"]
        sf = vc.spatial_downsample_factor
        h, w = z.shape[-2:]
        size = tuple(p.get("decode_tile_size", (1024, 1024)))
        if not p.get("decode_tiled") or (h <= max(1, size[0] // sf) and w <= max(1, size[1] // sf)):
            return ref.vae.decode(z)
        ov = tuple(p.get("decode_tile_overlap", (128, 128)))
        th, rows, rh = decode_grid(h, size[0], ov[0], sf)
        tw, cols, rw = decode_grid(w, size[1], ov[1], sf)
        return blend_tiles(ref.vae.decode, z, rows, cols, (th, tw), (rh, rw), 1, (h * sf, w * sf))

    def _batch(self, ref, req: Request, k: int, device):
        """Batch k of a request decoded, before the colour fix: float32
        [n, 3, true_h, true_w] in [-1, 1] (n its real frames)."""
        import torch

        from ..reference.numerics import strict_fp32
        from ..reference.pipeline import resize_dims, transform

        start, end = batch_ranges(req.frames.shape[0], self.batch, self.overlap)[k]
        frames = torch.from_numpy(req.frames[start:end]).to(device)
        n = frames.shape[0]
        if n % 4 != 1:  # time-reversed frames appended up to 4n + 1
            pad = (n - 1) // 4 * 4 + 5 - n
            if pad >= n:
                raise ValueError("phasedclips: a last batch too short to pad")
            frames = torch.cat([frames, frames[-pad - 1 : -1].flip(0)])
        vc, dc = ref.cfg.vae, ref.cfg.diffusion
        if (dc.sampling_steps, dc.cfg_scale, dc.prediction_type) != (1, 1.0, "v_lerp"):
            raise NotImplementedError("one v_lerp step without guidance")
        with strict_fp32(), torch.no_grad():
            tv = transform(frames, req.resolution)
            th, tw = resize_dims(*req.frames.shape[1:3], req.resolution)
            latent = self._encode(ref, tv.permute(1, 0, 2, 3)[None]).permute(0, 2, 3, 4, 1)  # [1, t, h, w, C]
            del tv
            gen = torch.Generator(device=device).manual_seed(req.seed)
            noise = torch.randn(tuple(latent.shape[1:]), generator=gen, device=device, dtype=torch.float32)[None]
            cond = torch.cat([latent, torch.ones_like(latent[..., :1])], dim=-1)
            t = torch.full((1,), dc.schedule_T, dtype=torch.float32, device=device)
            x0 = noise - ref.dit.forward(torch.cat([noise, cond], dim=-1), ref.text[None], t)
            del cond, noise, latent
            dec = self._decode(ref, (x0 / vc.scaling_factor + vc.shifting_factor).permute(0, 4, 1, 2, 3))[0]
        return dec.permute(1, 0, 2, 3)[:n, :, : th // 2 * 2, : tw // 2 * 2].contiguous()

    def reference_codes(self, ref, req: Request, lo: int, hi: int, device) -> np.ndarray:
        """The reference's codes of frames [lo, hi) of a request."""
        import torch

        from ..reference.numerics import strict_fp32
        from ..reference.pipeline import transform, wavelet_fix

        sources = frame_sources(req.frames.shape[0], self.batch, self.overlap)[lo:hi]
        batches = {k: self._batch(ref, req, k, device) for k in sorted({k for src in sources for k, _ in src})}
        content = torch.stack([sum(batches[k][j] * w for (k, j), w in src.items()) for src in sources])
        with strict_fp32():
            tv = transform(torch.from_numpy(req.frames[lo:hi]).to(device), req.resolution)
            fixed = wavelet_fix(content, tv[:, :, : content.shape[2], : content.shape[3]])
            codes = ((fixed * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0 + 0.5).floor()
        return codes.to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()
