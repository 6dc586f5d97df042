"""The released model files and which model a checkpoint file holds (the
port's copy of seedvr2_tpu/io/registry.py's table, its defaults,
``available_models`` and ``model_variant``). The downloader, the hashes and
the repositories stay out: the port reads local files only."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class ModelInfo:
    category: str = "dit"
    precision: str = "fp16"
    size: str = "3B"
    variant: Optional[str] = None


MODEL_REGISTRY: Dict[str, ModelInfo] = {
    "seedvr2_ema_3b-Q4_K_M.gguf": ModelInfo(size="3B", precision="Q4_K_M"),
    "seedvr2_ema_3b-Q8_0.gguf": ModelInfo(size="3B", precision="Q8_0"),
    "seedvr2_ema_3b_fp8_e4m3fn.safetensors": ModelInfo(size="3B", precision="fp8_e4m3fn"),
    "seedvr2_ema_3b_fp16.safetensors": ModelInfo(size="3B", precision="fp16"),
    "seedvr2_ema_7b-Q4_K_M.gguf": ModelInfo(size="7B", precision="Q4_K_M"),
    "seedvr2_ema_7b_fp8_e4m3fn_mixed_block35_fp16.safetensors": ModelInfo(
        size="7B", precision="fp8_e4m3fn_mixed_block35_fp16"),
    "seedvr2_ema_7b_fp16.safetensors": ModelInfo(size="7B", precision="fp16"),
    "seedvr2_ema_7b_sharp-Q4_K_M.gguf": ModelInfo(size="7B", precision="Q4_K_M", variant="sharp"),
    "seedvr2_ema_7b_sharp_fp8_e4m3fn_mixed_block35_fp16.safetensors": ModelInfo(
        size="7B", precision="fp8_e4m3fn_mixed_block35_fp16", variant="sharp"),
    "seedvr2_ema_7b_sharp_fp16.safetensors": ModelInfo(size="7B", precision="fp16", variant="sharp"),
    "ema_vae_fp16.safetensors": ModelInfo(category="vae", precision="fp16"),
}

DEFAULT_DIT = "seedvr2_ema_3b_fp16.safetensors"  # the CLI's and the DiT node's default
DEFAULT_VAE = "ema_vae_fp16.safetensors"


def available_models(category: str) -> List[str]:
    """The table's file names of one category ("dit" or "vae"), in order."""
    return [k for k, v in MODEL_REGISTRY.items() if v.category == category]


def model_variant(model_name: str) -> str:
    """'7b' iff '7b' appears in the name, else '3b'. 'tiny' selects the
    smoke-test configuration (CI-sized models, not a released variant)."""
    low = model_name.lower()
    if "tiny" in low:
        return "tiny"
    return "7b" if "7b" in low else "3b"
