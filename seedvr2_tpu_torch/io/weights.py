"""Weights -> the port's modules.

Two sources, one path: a parameter tree in the JAX package's layout (nested
dicts of numpy arrays) is flattened with ``checkpoint.flatten_tree``; a
reference safetensors checkpoint goes through the key maps and converters
of io/checkpoint.py to the same flat layout. ``load_flat`` then fills the
modules, converting each conv weight once to the layout of its route (K1:
[27, Cin, Cout]; K2: the fold, computed at load).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import DiTConfig, VAEConfig
from ..models.dit.nadit import NaDiT
from ..models.params import init_random, load_flat
from ..models.vae.model import VAE
from .checkpoint import convert_state_dict, dit_key_map, flatten_tree, load_safetensors, vae_key_map
from .checkpoint import load_text_embeddings  # noqa: F401  (bundled pos/neg embeddings)


def dit_from_flat(flat: Dict, cfg: DiTConfig, device, dtype=torch.bfloat16, tensor: int = 1) -> NaDiT:
    """``tensor`` > 1: ``flat`` holds one tensor rank's part
    (parallel/sharding.py:shard_flat)."""
    return load_flat(NaDiT(cfg, device, dtype, tensor=tensor), flat).eval()


def vae_from_flat(flat: Dict, cfg: VAEConfig, device, dtype=torch.bfloat16) -> VAE:
    return load_flat(VAE(cfg, device, dtype), flat).eval()


def dit_from_jax(params, cfg: DiTConfig, device, dtype=torch.bfloat16) -> NaDiT:
    """params: a DiT tree in the JAX package's init_params layout, numpy leaves."""
    return dit_from_flat(flatten_tree(params), cfg, device, dtype)


def vae_from_jax(params, cfg: VAEConfig, device, dtype=torch.bfloat16) -> VAE:
    return vae_from_flat(flatten_tree(params), cfg, device, dtype)


def dit_from_safetensors(path: str, cfg: DiTConfig, device, dtype=torch.bfloat16, tensor_rank: int = 0,
                         tensor_size: int = 1) -> NaDiT:
    """``tensor_size`` > 1: only tensor rank ``tensor_rank``'s part, sliced
    in host memory before anything moves to ``device``."""
    from ..parallel.sharding import shard_flat

    flat = convert_state_dict(load_safetensors(path), dit_key_map(cfg), dtype=None)
    if tensor_size > 1:
        flat = shard_flat(flat, cfg, tensor_rank, tensor_size)
    return dit_from_flat(flat, cfg, device, dtype, tensor=tensor_size)


def vae_from_safetensors(path: str, cfg: VAEConfig, device, dtype=torch.bfloat16) -> VAE:
    return vae_from_flat(convert_state_dict(load_safetensors(path), vae_key_map(cfg), dtype=None), cfg, device, dtype)


def random_dit(cfg: DiTConfig, generator: torch.Generator, dtype=torch.bfloat16) -> NaDiT:
    """Random weights drawn on the generator's device (no host copy)."""
    return init_random(NaDiT(cfg, generator.device, dtype), generator).eval()


def random_vae(cfg: VAEConfig, generator: torch.Generator, dtype=torch.bfloat16) -> VAE:
    return init_random(VAE(cfg, generator.device, dtype), generator).eval()


def save_random_checkpoint(path: str, kind: str, cfg, generator: torch.Generator, dtype=torch.bfloat16) -> None:
    """Write seeded random weights (``kind`` "dit" or "vae"; the draws of
    random_dit / random_vae, on the generator's device) to ``path`` as a
    safetensors file in the reference's layout, each tensor in ``dtype``:
    a checkpoint that load_runner reads like a released one."""
    from safetensors.torch import save_file

    from ..models.params import random_leaves
    from .checkpoint import export_state_dict

    module, key_map = (NaDiT(cfg, "meta", dtype), dit_key_map(cfg)) if kind == "dit" else (VAE(cfg, "meta", dtype),
                                                                                           vae_key_map(cfg))
    flat = {path_: t.to(dtype) for path_, _, _, t in random_leaves(module, generator)}
    state = {k: v.to("cpu", copy=True).contiguous() for k, v in export_state_dict(flat, key_map).items()}
    del flat
    save_file(state, path)
