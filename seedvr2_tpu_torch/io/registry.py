"""Which model a checkpoint file holds (the port's copy of
seedvr2_tpu/io/registry.py:model_variant)."""

from __future__ import annotations


def model_variant(model_name: str) -> str:
    """'7b' iff '7b' appears in the name, else '3b'. 'tiny' selects the
    smoke-test configuration (CI-sized models, not a released variant)."""
    low = model_name.lower()
    if "tiny" in low:
        return "tiny"
    return "7b" if "7b" in low else "3b"


DEFAULT_DIT = "seedvr2_ema_3b_fp16.safetensors"  # the CLI's DiT without --dit_model
