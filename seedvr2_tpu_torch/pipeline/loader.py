"""Checkpoint files -> a ready Runner (counterpart of
seedvr2_tpu/pipeline/loader.py). Reads local safetensors only; it
downloads nothing."""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..config import PipelineConfig, dit_3b, dit_7b, vae_config
from ..io.checkpoint import load_text_embeddings
from ..io.registry import model_variant
from ..io.weights import dit_from_safetensors, vae_from_safetensors
from ..ops.attention import resolve_attention_mode
from ..parallel.mesh import AXIS_TENSOR, Mesh
from ..parallel.sharding import check_tensor_split
from .runner import _DTYPES, Runner, _not_ported, check_supported


def dit_param_bytes(dit_cfg, quantize: Optional[str] = None) -> int:
    """Resident bytes of the DiT's weights (bf16; 1 byte a weight for
    int8), counted on a module built on the meta device (no allocation):
    the weight term of the mesh policy (parallel/mesh.py:auto_mesh_shape).
    The port's copy of seedvr2_tpu/pipeline/loader.py:dit_param_bytes."""
    from ..models.dit.nadit import NaDiT

    n = sum(b.numel() for b in NaDiT(dit_cfg, "meta", torch.bfloat16).buffers())
    return n * (1 if quantize == "int8" else 2)


def pick_config(dit_model: str, cfg: Optional[PipelineConfig] = None) -> PipelineConfig:
    """The DiT variant follows the file name, as in the JAX loader: "7b" in
    it picks NaDiT-7B, otherwise 3B; a 3B/7B ``cfg`` that the name
    contradicts is corrected, a custom one ("tiny", ...) is kept."""
    inferred = dit_7b() if model_variant(dit_model) == "7b" else dit_3b()
    if cfg is None:
        return PipelineConfig(dit=inferred, vae=vae_config())
    if cfg.dit.variant in ("3b", "7b") and cfg.dit.variant != inferred.variant:
        return cfg.replace(dit=inferred)
    return cfg


def load_runner(
    dit_model: str,
    vae_model: str = "ema_vae_fp16.safetensors",
    model_dir: str = "./models",
    cfg: Optional[PipelineConfig] = None,
    device="cuda",
    quantize: Optional[str] = None,
    emb_dir: Optional[str] = None,
    attention_mode: str = "fused",
    mesh: Optional[Mesh] = None,
) -> Runner:
    """The DiT config follows the file name (``pick_config``).
    ``attention_mode`` is a name of ops/attention.py's alias table (fused,
    sdpa, flash_attn_2/3, sageattn_2/3, ...).

    ``mesh``: this rank's mesh (parallel/mesh.py); the runner then runs on
    ``mesh.device`` (``device`` is ignored). On a mesh whose tensor axis is
    above 1 only this rank's part of the DiT is loaded
    (parallel/sharding.py), sliced in host memory before it moves to the
    card."""
    resolve_attention_mode(attention_mode)  # an unknown name raises before any weight is read
    cfg = pick_config(dit_model, cfg)
    check_supported(cfg)
    tensor = mesh.shape[AXIS_TENSOR] if mesh is not None else 1
    check_tensor_split(cfg.dit, tensor)
    if quantize is not None:
        raise _not_ported(f"quantize={quantize!r}", "int8 DiT with a W8A16 kernel")
    if not dit_model.endswith(".safetensors") or not vae_model.endswith(".safetensors"):
        raise _not_ported("checkpoints other than .safetensors", "GGUF")
    paths = [os.path.join(model_dir, m) for m in (dit_model, vae_model)]
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    device = mesh.device if mesh is not None else torch.device(device)
    dtype = _DTYPES[cfg.compute_dtype]
    t_rank = mesh.coord(AXIS_TENSOR) if mesh is not None else 0
    dit = dit_from_safetensors(paths[0], cfg.dit, device, dtype, t_rank, tensor).set_attention_mode(attention_mode)
    vae = vae_from_safetensors(paths[1], cfg.vae, device, dtype)
    pos, neg = load_text_embeddings(emb_dir)
    width = cfg.dit.txt_in_dim
    return Runner(cfg, dit, vae, pos[:, :width], device=device, mesh=mesh, text_neg=neg[:, :width])
