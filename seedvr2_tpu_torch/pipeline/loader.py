"""Checkpoint files -> a ready Runner (counterpart of
seedvr2_tpu/pipeline/loader.py). Reads safetensors, GGUF and .pth
checkpoints through the weights cache (io/native_ckpt.py), and fetches a
missing released file first (io/registry.py:download_model)."""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..config import PipelineConfig, dit_3b, dit_7b, vae_config
from ..io import registry
from ..io.checkpoint import load_text_embeddings
from ..io.registry import model_variant
from ..io.weights import load_cached
from ..ops.attention import resolve_attention_mode
from ..parallel.mesh import AXIS_TENSOR, Mesh
from ..parallel.sharding import check_tensor_split
from ..utils.debug import Debug
from .runner import _DTYPES, Runner, check_supported


def dit_param_bytes(dit_cfg, quantize: Optional[str] = None) -> int:
    """Resident bytes of the DiT's weights (bf16; 1 byte a weight for
    int8), counted on a module built on the meta device (no allocation):
    the weight term of the mesh policy (parallel/mesh.py:auto_mesh_shape).
    The port's copy of seedvr2_tpu/pipeline/loader.py:dit_param_bytes."""
    from ..models.dit.nadit import NaDiT

    n = sum(b.numel() for b in NaDiT(dit_cfg, "meta", torch.bfloat16).buffers())
    return n * (1 if quantize == "int8" else 2)


def auto_quantize(dit_cfg, quantize: Optional[str], hbm_bytes: int) -> Optional[str]:
    """The loader's quantization default: int8 for 7B on a device of under
    20 GiB (its bf16 weights, ~15 GiB, leave no room for the activations),
    else ``quantize`` as given (the port's copy of
    seedvr2_tpu/pipeline/loader.py:auto_quantize)."""
    if quantize is None and dit_cfg.variant == "7b" and hbm_bytes < 20 << 30:
        return "int8"
    return quantize


def resident_quantize(dit_cfg, dit_model: str, quantize: Optional[str], hbm_bytes: int) -> Optional[str]:
    """The DiT's storage as load_runner decides it: auto_quantize, and int8
    for every .gguf DiT."""
    return "int8" if dit_model.endswith(".gguf") else auto_quantize(dit_cfg, quantize, hbm_bytes)


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
    debug: Optional[Debug] = None,
    download: bool = True,
) -> Runner:
    """The DiT config follows the file name (``pick_config``).
    ``attention_mode`` is a name of ops/attention.py's alias table (fused,
    sdpa, flash_attn_2/3, sageattn_2/3, ...).

    Checkpoints: .safetensors, .gguf or .pth/.pt, each file by its own
    extension. ``quantize="int8"`` stores the DiT's block linears as int8
    (ops/quant.py; K7 runs them on the card); None is the default of
    ``auto_quantize`` (int8 for 7B on a device of under 20 GiB). A .gguf
    DiT is always dequantized and re-quantized to int8; a .gguf or .pth
    VAE is dequantized and kept in the compute dtype.

    ``download``: a missing file is first fetched from its Hugging Face
    repository and its hash checked (io/registry.py:download_model); with
    ``download=False`` it raises FileNotFoundError. Each file is then read
    through the weights cache (io/native_ckpt.py): converted on its first
    load and written to ``<model_dir>/torch_cache/``, read from there on
    later loads until the file changes.

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
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize={quantize!r}: None or 'int8'")
    paths = [os.path.join(model_dir, m) for m in (dit_model, vae_model)]
    for name, p in zip((dit_model, vae_model), paths):
        if not os.path.exists(p):
            if not download:
                raise FileNotFoundError(p)
            registry.download_model(name, model_dir)
    debug = debug or Debug()
    device = mesh.device if mesh is not None else torch.device(device)
    dtype = _DTYPES[cfg.compute_dtype]
    t_rank = mesh.coord(AXIS_TENSOR) if mesh is not None else 0
    from .phases import _hbm_bytes

    hbm = _hbm_bytes(device)
    if auto_quantize(cfg.dit, quantize, hbm) != quantize:
        debug.log("7B on <20GB HBM: defaulting to int8 weight storage", category="dit", force=True)
    quantize = resident_quantize(cfg.dit, dit_model, quantize, hbm)
    debug.log(f"Loading DiT weights: {paths[0]}", category="dit", force=True)
    dit = load_cached("dit", paths[0], cfg.dit, device, dtype, t_rank, tensor, quantize, debug)
    dit.set_attention_mode(attention_mode)
    debug.log(f"Loading VAE weights: {paths[1]}", category="vae", force=True)
    vae = load_cached("vae", paths[1], cfg.vae, device, dtype, debug=debug)
    pos, neg = load_text_embeddings(emb_dir)
    width = cfg.dit.txt_in_dim
    return Runner(cfg, dit, vae, pos[:, :width], device=device, mesh=mesh, text_neg=neg[:, :width], debug=debug)
