"""Seeded random weights in the published checkpoints' keys and layouts,
drawn on the device, and their way into the program.

``draw`` fills every tensor of a layout (reference/dit.py:spec,
reference/vae.py:spec) from one torch.Generator on the device: all normal
draws of a model in a few large ``torch.randn`` calls in the served type,
each slice then scaled in place. The same seed on the same device gives the
same bits, so the reference draws its own copy after the program's run.

``to_program`` hands a state dict to the program as a checkpoint reaches
it: through the program's key maps (io/checkpoint.py:dit_key_map,
vae_key_map) and its loaders of flat dicts (io/weights.py:dit_from_flat,
vae_from_flat). The key maps' layout transforms run here on the device
(the program's own convert_state_dict takes host numpy arrays): one
tensor at a time, each state tensor released once it is consumed.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .reference import dit as ref_dit
from .reference import vae as ref_vae

GROUP_ELEMS = 1 << 30  # the normal draws of one randn call, at most
INITS = ("normal", "1+normal", "identity+normal")


def draw(layout: List[Tuple[str, tuple, str, float]], generator: torch.Generator, dtype) -> Dict[str, torch.Tensor]:
    """Every tensor of ``layout`` on the generator's device, in ``dtype``.
    The normal draws come in a few calls of up to GROUP_ELEMS each."""
    dev = generator.device
    out: Dict[str, torch.Tensor] = {}
    group: List[Tuple[str, tuple, str, float]] = []
    pending = 0  # elements in ``group``

    def flush():
        nonlocal pending
        n, pending = pending, 0
        buf = torch.randn(n, generator=generator, device=dev, dtype=dtype)
        off = 0
        for key, shape, init, scale in group:
            k = int(np.prod(shape))
            t = buf[off : off + k].view(shape).mul_(scale)
            if init == "1+normal":
                t.add_(1.0)
            elif init == "identity+normal":  # [r * C, C, 1, 1, 1]: + 1 where o % C == i
                c = shape[1]
                t.view(shape[0] // c, c, c).diagonal(dim1=1, dim2=2).add_(1.0)
            out[key] = t
            off += k
        group.clear()

    for key, shape, init, scale in layout:
        if init not in INITS:
            raise ValueError(init)
        if group and pending + int(np.prod(shape)) > GROUP_ELEMS:
            flush()
        group.append((key, shape, init, scale))
        pending += int(np.prod(shape))
    if group:
        flush()
    return {key: out[key] for key, _, _, _ in layout}


def draw_models(raw_config: dict, seed: int, device, dtype) -> Tuple[Dict, Dict]:
    """(DiT state dict, VAE state dict) of a configuration file, drawn from
    ``seed`` (the DiT first, then the VAE, from one generator)."""
    from .reference.pipeline import config

    cfg = config(raw_config)
    g = torch.Generator(device=device).manual_seed(seed)
    dit = draw(ref_dit.spec(cfg.dit), g, dtype)
    vae = draw(ref_vae.spec(cfg.vae), g, dtype)
    return dit, vae


_TRANSFORMS = {  # torch [out, in] / OIDHW / fused qkv -> the program's flat layout, on the device
    "none": lambda x: x,
    "linear": lambda w: w.t().contiguous(),
    "conv3d": lambda w: w.permute(2, 3, 4, 1, 0).contiguous(),
    "qkv_w": lambda w: w.t().reshape(w.shape[1], 3, w.shape[0] // 3).contiguous(),
    "qkv_b": lambda b: b.reshape(3, -1),
}


class FlatView(Mapping):
    """A state dict seen through a key map as the program's flat dict:
    each leaf transformed when it is read, and its state tensor dropped
    from ``state`` once ``items()`` has handed it on."""

    def __init__(self, state: Dict[str, torch.Tensor], key_map: Dict[str, Tuple[str, str]]):
        missing = [theirs for theirs, _ in key_map.values() if theirs not in state]
        extra = set(state) - {theirs for theirs, _ in key_map.values()}
        if missing or extra:
            raise KeyError(f"layout and key map differ: missing {missing[:3]}, unexpected {sorted(extra)[:3]}")
        self.state, self.key_map = state, key_map

    def __getitem__(self, ours: str) -> torch.Tensor:
        theirs, kind = self.key_map[ours]
        return _TRANSFORMS[kind](self.state[theirs])

    def __iter__(self) -> Iterator[str]:
        return iter(self.key_map)

    def __len__(self) -> int:
        return len(self.key_map)

    def items(self):
        for ours, (theirs, kind) in self.key_map.items():
            yield ours, _TRANSFORMS[kind](self.state.pop(theirs))


def to_program(port_cfg, dit_state: Dict, vae_state: Dict, device, dtype, raw_config: dict):
    """The program's NaDiT and VAE, filled from the two state dicts (which
    are emptied on the way), as the configuration file states them: its
    ``attention_mode``, ``gn_fusion`` and ``dit_quantize`` (null, or
    "int8": the DiT's block linears stored int8 by the program's
    quantize_dit_params, as its loader stores them)."""
    from seedvr2_tpu_torch.io.checkpoint import dit_key_map, vae_key_map
    from seedvr2_tpu_torch.io.weights import dit_from_flat, vae_from_flat
    from seedvr2_tpu_torch.ops.quant import quantize_dit_params

    flat = FlatView(dit_state, dit_key_map(port_cfg.dit))
    quantize = raw_config.get("dit_quantize")
    if quantize not in (None, "int8"):
        raise ValueError(f"dit_quantize {quantize!r}: null or int8")
    dit = dit_from_flat(quantize_dit_params(flat) if quantize else flat, port_cfg.dit, device, dtype)
    dit.set_attention_mode(raw_config["attention_mode"])
    vae = vae_from_flat(FlatView(vae_state, vae_key_map(port_cfg.vae)), port_cfg.vae, device, dtype)
    vae.set_gn_fusion(raw_config.get("gn_fusion", False))
    return dit, vae
