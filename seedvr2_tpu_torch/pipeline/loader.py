"""Checkpoint files -> a ready Runner (counterpart of
seedvr2_tpu/pipeline/loader.py). Reads local safetensors only; it
downloads nothing."""

from __future__ import annotations

import os
from typing import Optional

import torch

from seedvr2_tpu.config import PipelineConfig
from seedvr2_tpu.io import weights as jax_weights

from ..io.weights import dit_from_safetensors, vae_from_safetensors
from .runner import _DTYPES, Runner, _not_ported, check_supported


def load_runner(
    dit_model: str,
    vae_model: str = "ema_vae_fp16.safetensors",
    model_dir: str = "./models",
    cfg: Optional[PipelineConfig] = None,
    device="cuda",
    quantize: Optional[str] = None,
    emb_dir: Optional[str] = None,
) -> Runner:
    cfg = cfg or PipelineConfig()
    check_supported(cfg)
    if quantize is not None:
        raise _not_ported(f"quantize={quantize!r}", "int8 DiT with a W8A16 kernel")
    if not dit_model.endswith(".safetensors") or not vae_model.endswith(".safetensors"):
        raise _not_ported("checkpoints other than .safetensors", "the rest of the pipeline")
    paths = [os.path.join(model_dir, m) for m in (dit_model, vae_model)]
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    device = torch.device(device)
    dtype = _DTYPES[cfg.compute_dtype]
    dit = dit_from_safetensors(paths[0], cfg.dit, device, dtype)
    vae = vae_from_safetensors(paths[1], cfg.vae, device, dtype)
    pos, _neg = jax_weights.load_text_embeddings(emb_dir)
    return Runner(cfg, dit, vae, pos[:, : cfg.dit.txt_in_dim], device=device)
