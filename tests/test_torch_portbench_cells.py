"""The benchmark's int8 configuration and long-clip traffic against its
plain reference (portbench/reference/), on the CPU at tiny sizes with
seeded weights drawn by portbench/weights.py and handed to the port
through its loaders:

- a tiny DiT of NaDiT-7B's shape (a text stream in every layer, GELU MLP,
  window_pixel RoPE, the unfused window path) with ``dit_quantize`` int8,
  against the reference DiT on the int8 codes and per-column scales
  (tight), and against the reference on weights that the int8 storage
  does not hold (the unquantized ones, whose gap is the int8 rounding that
  the card's comparison absorbs; bf16 ones; a per-tensor scale);
- the ``phasedclips`` kind's reference, which tiles and blends, against
  the port's 4-phase route on a clip of two overlapping batches whose
  encode and decode take several tiles.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from portbench import weights
from portbench.reference.dit import DiT
from portbench.reference.numerics import Numerics, strict_fp32
from portbench.reference.pipeline import Reference, config
from portbench.run import port_config, text_embedding
from portbench.traffic import phasedclips
from seedvr2_tpu_torch.config import DiffusionConfig, dit_tiny, vae_tiny
from seedvr2_tpu_torch.models.dit.nadit import build_attn_plans, device_plans
from seedvr2_tpu_torch.pipeline.runner import Runner


def _plain(x) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(x).items()}


def _raw(dc, quantize=None, attention="flash_attn_2") -> dict:
    """A configuration file's contents (portbench/configs/*.json), float32."""
    return {"name": "tiny", "source": "test", "reduced": [], "precision": "float32", "attention_mode": attention,
            "gn_fusion": False, "dit_quantize": quantize, "dit": _plain(dc), "vae": _plain(vae_tiny()),
            "diffusion": _plain(DiffusionConfig())}


def _cell(raw, pipeline):
    return type("Cell", (), {"config": raw, "traffic": {"pipeline": pipeline}})


# NaDiT-7B's shape at a width where every block linear holds at least
# ops/quant.py's 65,536 weights, so that quantize_dit_params stores each int8
DIT_7B_TINY = dataclasses.replace(
    dit_tiny("window_pixel"), vid_dim=256, txt_dim=256, emb_dim=6 * 256, heads=2, head_dim=128, rope_dim=64,
    mm_layers=2, num_layers=2, vid_in_channels=2 * vae_tiny().latent_channels + 1,
    vid_out_channels=vae_tiny().latent_channels, txt_in_dim=5120)
BLOCK_LINEARS = ("attn.proj_qkv", "attn.proj_out", "mlp.{}.proj_in", "mlp.{}.proj_out")
TIGHT = 1e-4  # rel L2 of the DiT's output: the same products in float32, summed in another order


def _quantized(w: torch.Tensor, per_column: bool = True) -> torch.Tensor:
    """A torch-layout weight [out, in] as its int8 codes times their scale,
    widened to float32: absmax over the contraction axis / 127 for each
    output column (per_column), or over the whole matrix."""
    absmax = w.abs().amax(dim=1, keepdim=True) if per_column else w.abs().amax()
    scale = absmax / 127.0
    return torch.round(w / scale.clamp_min(1e-12)).clamp(-127, 127) * scale


def _block_keys(sd):
    for i in range(DIT_7B_TINY.num_layers):
        for br in ("vid", "txt"):
            for name in BLOCK_LINEARS:
                key = f"blocks.{i}.{name.format(br)}" + (f".{br}" if name.startswith("attn") else "")
                yield f"{key}.weight"


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("weights_of_reference, low, high", [
    ("int8 codes x per-column scales", 0.0, TIGHT),
    ("unquantized", 1e-3, 3e-2),  # the int8 rounding that the card's comparison absorbs
    ("bf16", 1e-3, 1.0),
    ("int8 codes x one scale a tensor", 1e-3, 1.0),
])
def test_int8_dit_against_the_reference(weights_of_reference, low, high):
    raw = _raw(DIT_7B_TINY, "int8")
    cfg = port_config(_cell(raw, {}))
    dit, _ = weights.to_program(cfg, *weights.draw_models(raw, 17, "cpu", torch.float32), "cpu", torch.float32, raw)
    assert sum("w_q" in m.spec for m in dit.modules() if hasattr(m, "spec")) == 2 * 2 * len(BLOCK_LINEARS)
    sd, _ = weights.draw_models(raw, 17, "cpu", torch.float32)
    keys = list(_block_keys(sd))
    assert len(keys) == 2 * 2 * len(BLOCK_LINEARS) and all(k in sd for k in keys)
    for k in keys:
        w = sd[k].float()
        sd[k] = {"int8 codes x per-column scales": lambda: _quantized(w),
                 "unquantized": lambda: w,
                 "bf16": lambda: w.bfloat16().float(),
                 "int8 codes x one scale a tensor": lambda: _quantized(w, per_column=False)}[weights_of_reference]()

    g = torch.Generator().manual_seed(3)
    vid = torch.randn(1, 2, 8, 12, DIT_7B_TINY.vid_in_channels, generator=g)
    txt = torch.from_numpy(text_embedding(DIT_7B_TINY.txt_in_dim))[None, :9]
    t = torch.full((1,), 1000.0)
    thw = (2, 4, 6)
    with torch.no_grad():
        prog = dit(vid, txt, t, device_plans(build_attn_plans(DIT_7B_TINY, thw, txt.shape[1]), 128, "cpu"))
        with strict_fp32():
            ref = DiT(config(raw).dit, sd, Numerics()).forward(vid, txt, t)
    assert low <= _rel(prog, ref) <= high, _rel(prog, ref)


LONGCLIP_TINY = {
    "kind": "phasedclips", "sizes": [[24, 40]], "frames": 15, "resolution": 48, "pool": 1, "loop": "closed",
    "pipeline": {"batch_size": 9, "temporal_overlap": 3, "encode_tiled": True, "decode_tiled": True,
                 "encode_tile_size": [32, 32], "encode_tile_overlap": [16, 16], "decode_tile_size": [32, 32],
                 "decode_tile_overlap": [16, 16], "color_correction": "wavelet", "output_bits": 8}}


def test_phasedclips_reference_tiles_and_blends_as_the_program():
    """Two batches of 9 frames overlapping by 3 (the Hann blend), each
    encoded on a 2 x 4 grid of latent tiles and decoded on the same grid
    in pixels: the reference's codes against the port's 4-phase route,
    both in float32, agree but for rounding at a code boundary."""
    raw = _raw(dataclasses.replace(dit_tiny(), vid_in_channels=2 * vae_tiny().latent_channels + 1,
                                   vid_out_channels=vae_tiny().latent_channels, txt_in_dim=5120), attention="fused")
    mix = phasedclips.Mix(LONGCLIP_TINY, 5)
    req = mix.request(0)
    assert phasedclips.batch_ranges(15, 9, 3) == [(0, 9), (6, 15)]
    (_, rows, _), (_, cols, _) = phasedclips.encode_grid(6, 32, 16, 8), phasedclips.encode_grid(10, 32, 16, 8)
    assert (len(rows), len(cols)) == (2, 4)
    (_, rows, ramp_h), (_, cols, ramp_w) = phasedclips.decode_grid(6, 32, 16, 8), phasedclips.decode_grid(10, 32, 16, 8)
    assert (len(rows), len(cols), ramp_h, ramp_w) == (2, 4, 16, 16)

    cfg = port_config(_cell(raw, LONGCLIP_TINY["pipeline"]))
    text = text_embedding(cfg.dit.txt_in_dim)
    dit, vae = weights.to_program(cfg, *weights.draw_models(raw, 9, "cpu", torch.float32), "cpu", torch.float32, raw)
    out = mix.call(Runner(cfg, dit, vae, text, device="cpu"), cfg, req)
    assert out.dtype == np.float32 and out.shape == (15, 48, 80, 3)  # the 4-phase route's frames in [0, 1]
    prog = mix.program_codes(out, 0, 15)
    ref = Reference(raw, *weights.draw_models(raw, 9, "cpu", torch.float32), torch.from_numpy(text))
    codes = np.concatenate([mix.reference_codes(ref, req, lo, hi, "cpu") for lo, hi in ((0, 9), (9, 15))])
    assert codes.shape == prog.shape
    d = np.abs(codes.astype(int) - prog.astype(int))
    assert d.max() <= 1 and d.mean() < 1e-2
