"""Weights -> the port's modules.

Two sources, one path: a JAX parameter tree (as numpy arrays) is flattened
with seedvr2_tpu.io.weights.flatten_tree; a reference safetensors
checkpoint goes through the JAX package's key maps and converters to the
same flat layout. ``load_flat`` then fills the modules, converting each
conv weight once to the layout of its route (K1: [27, Cin, Cout]; K2: the
fold, computed at load).
"""

from __future__ import annotations

from typing import Dict

import torch

from seedvr2_tpu.config import DiTConfig, VAEConfig
from seedvr2_tpu.io import weights as jax_weights
from seedvr2_tpu.io.weights import load_text_embeddings  # noqa: F401  (bundled pos/neg embeddings)

from ..models.dit.nadit import NaDiT
from ..models.params import init_random, load_flat
from ..models.vae.model import VAE


def dit_from_flat(flat: Dict, cfg: DiTConfig, device, dtype=torch.bfloat16) -> NaDiT:
    return load_flat(NaDiT(cfg, device, dtype), flat).eval()


def vae_from_flat(flat: Dict, cfg: VAEConfig, device, dtype=torch.bfloat16) -> VAE:
    return load_flat(VAE(cfg, device, dtype), flat).eval()


def dit_from_jax(params, cfg: DiTConfig, device, dtype=torch.bfloat16) -> NaDiT:
    """params: the JAX package's DiT tree (init_params layout, numpy leaves)."""
    return dit_from_flat(jax_weights.flatten_tree(params), cfg, device, dtype)


def vae_from_jax(params, cfg: VAEConfig, device, dtype=torch.bfloat16) -> VAE:
    return vae_from_flat(jax_weights.flatten_tree(params), cfg, device, dtype)


def dit_from_safetensors(path: str, cfg: DiTConfig, device, dtype=torch.bfloat16) -> NaDiT:
    state = jax_weights.load_state_dict_any(path)
    return dit_from_flat(jax_weights.convert_state_dict(state, jax_weights.dit_key_map(cfg)), cfg, device, dtype)


def vae_from_safetensors(path: str, cfg: VAEConfig, device, dtype=torch.bfloat16) -> VAE:
    state = jax_weights.load_state_dict_any(path)
    return vae_from_flat(jax_weights.convert_state_dict(state, jax_weights.vae_key_map(cfg)), cfg, device, dtype)


def random_dit(cfg: DiTConfig, generator: torch.Generator, dtype=torch.bfloat16) -> NaDiT:
    """Random weights drawn on the generator's device (no host copy)."""
    return init_random(NaDiT(cfg, generator.device, dtype), generator).eval()


def random_vae(cfg: VAEConfig, generator: torch.Generator, dtype=torch.bfloat16) -> VAE:
    return init_random(VAE(cfg, generator.device, dtype), generator).eval()
