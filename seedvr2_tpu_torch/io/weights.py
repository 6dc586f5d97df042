"""Weights -> the port's modules.

Two sources, one path: a parameter tree in the JAX package's layout (nested
dicts of numpy arrays) is flattened with ``checkpoint.flatten_tree``; a
reference checkpoint (safetensors, GGUF or .pth) goes through the key maps
and converters of io/checkpoint.py to the same flat layout, one tensor at a
time (``checkpoint_leaves``, models/params.py:``fill_leaves``: the host never
holds the whole model), and through the weights cache of io/native_ckpt.py
(``load_cached``). ``load_flat`` and ``fill_leaves`` fill the modules,
converting each conv weight once to the layout of its route (K1:
[27, Cin, Cout]; K2: the fold, computed at load).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import DiTConfig, VAEConfig
from ..models.dit.nadit import NaDiT, int8_linears
from ..models.params import fill_leaves, init_random, leaf_paths, load_flat
from ..models.vae.model import VAE
from . import native_ckpt
from .checkpoint import CheckpointReader, converted_tensors, dit_key_map, flatten_tree, vae_key_map
from .checkpoint import load_text_embeddings  # noqa: F401  (bundled pos/neg embeddings)


def dit_from_flat(flat: Dict, cfg: DiTConfig, device, dtype=torch.bfloat16, tensor: int = 1) -> NaDiT:
    """``tensor`` > 1: ``flat`` holds one tensor rank's part
    (parallel/sharding.py:shard_flat). Each linear whose ``w_q`` the dict
    holds (ops/quant.py:quantize_dit_params) is built int8."""
    int8 = {k[: -len("/w_q")] for k in flat if k.endswith("/w_q")}
    return load_flat(NaDiT(cfg, device, dtype, tensor=tensor, int8=int8), flat).eval()


def vae_from_flat(flat: Dict, cfg: VAEConfig, device, dtype=torch.bfloat16) -> VAE:
    return load_flat(VAE(cfg, device, dtype), flat).eval()


def dit_from_jax(params, cfg: DiTConfig, device, dtype=torch.bfloat16) -> NaDiT:
    """params: a DiT tree in the JAX package's init_params layout, numpy
    leaves; or that tree through its quantize_dit_params."""
    return dit_from_flat(flatten_tree(params), cfg, device, dtype)


def vae_from_jax(params, cfg: VAEConfig, device, dtype=torch.bfloat16) -> VAE:
    return vae_from_flat(flatten_tree(params), cfg, device, dtype)


def _check_quantize(quantize: Optional[str]) -> None:
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize={quantize!r}: None or 'int8'")


def checkpoint_leaves(path: str, key_map, quantize: Optional[str] = None):
    """A checkpoint's leaves one at a time: (flat path, tensor in the JAX
    layout) in the key map's order, each read, transformed and, with
    ``quantize="int8"``, quantized (ops/quant.py: a block linear's ``w``
    becomes ``w_q`` and ``w_s``) before the next is read. Raises on
    missing keys before the first leaf."""
    from ..ops.quant import quantize_linear, quantizes

    reader = CheckpointReader(path)
    try:
        leaves = converted_tensors(reader, key_map)
    except KeyError:
        reader.close()
        raise

    def gen():
        with reader:
            for ours, arr in leaves:
                if quantize == "int8" and quantizes(ours, arr.shape):
                    q = quantize_linear(arr)
                    del arr
                    yield ours[: -len("w")] + "w_q", q["w_q"]
                    yield ours[: -len("w")] + "w_s", q["w_s"]
                else:
                    yield ours, torch.as_tensor(arr)

    return gen()


def _modules(kind: str, cfg, device, dtype, tensor_size: int = 1, quantize: Optional[str] = None):
    """The module to fill (for a DiT, this tensor rank's part), the whole
    one whose leaves a checkpoint holds (on the meta device when the two
    differ) and the key map."""
    _check_quantize(quantize)
    if kind == "vae":
        if quantize is not None or tensor_size != 1:
            raise ValueError("the VAE is loaded whole and dense")
        root = VAE(cfg, device, dtype)
        return root, root, vae_key_map(cfg)
    int8 = int8_linears(cfg) if quantize == "int8" else ()
    root = NaDiT(cfg, device, dtype, tensor=tensor_size, int8=int8)
    whole = root if tensor_size == 1 else NaDiT(cfg, "meta", dtype, int8=int8)
    return root, whole, dit_key_map(cfg)


def dit_from_checkpoint(path: str, cfg: DiTConfig, device, dtype=torch.bfloat16, tensor_rank: int = 0,
                        tensor_size: int = 1, quantize: Optional[str] = None) -> NaDiT:
    """A .safetensors, .gguf or .pth/.pt DiT, streamed one tensor at a time
    (checkpoint_leaves, fill_leaves): converted to the JAX layout,
    quantized (``quantize="int8"``: each whole weight, ops/quant.py), cast,
    then with ``tensor_size`` > 1 sliced to tensor rank ``tensor_rank``'s
    part on the host before it moves to ``device``; no host copy of the
    whole model is made."""
    root, _, key_map = _modules("dit", cfg, device, dtype, tensor_size, quantize)
    return fill_leaves(root, checkpoint_leaves(path, key_map, quantize), tensor_rank, tensor_size).eval()


def vae_from_checkpoint(path: str, cfg: VAEConfig, device, dtype=torch.bfloat16) -> VAE:
    """A .safetensors, .gguf (dequantized) or .pth/.pt VAE in ``dtype``,
    streamed as dit_from_checkpoint."""
    root, _, key_map = _modules("vae", cfg, device, dtype)
    return fill_leaves(root, checkpoint_leaves(path, key_map)).eval()


def load_cached(kind: str, path: str, cfg, device, dtype=torch.bfloat16, tensor_rank: int = 0, tensor_size: int = 1,
                quantize: Optional[str] = None, debug=None):
    """dit_from_checkpoint (``kind`` "dit") or vae_from_checkpoint ("vae")
    through the weights cache (io/native_ckpt.py): read from
    ``<dir of path>/torch_cache/`` when it holds this file converted with
    these settings, else converted and written there on the way."""
    root, whole, key_map = _modules(kind, cfg, device, dtype, tensor_size, quantize)
    layout = [(p, m.load_dtype(leaf), tuple(m.spec[leaf][0])) for p, m, leaf in leaf_paths(whole)]
    return native_ckpt.load_or_convert(
        path, layout, native_ckpt.settings_for(kind, key_map, dtype, quantize, layout),
        convert=lambda sink: fill_leaves(root, checkpoint_leaves(path, key_map, quantize), tensor_rank, tensor_size,
                                         sink),
        read=lambda get: fill_leaves(root, ((p, get(p)) for p, _, _ in layout), tensor_rank, tensor_size),
        debug=debug, category=kind).eval()


def random_dit(cfg: DiTConfig, generator: torch.Generator, dtype=torch.bfloat16, quantize: Optional[str] = None) -> NaDiT:
    """Random weights drawn on the generator's device (no host copy);
    ``quantize="int8"``: the same draws, quantized there
    (models/params.py:random_leaves)."""
    _check_quantize(quantize)
    int8 = int8_linears(cfg) if quantize == "int8" else ()
    return init_random(NaDiT(cfg, generator.device, dtype, int8=int8), generator).eval()


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
