"""The port's configuration: the JAX package's frozen dataclasses
(seedvr2_tpu/config.py imports no jax), re-exported so that users of the
port import from one package."""

from seedvr2_tpu.config import (  # noqa: F401
    DiffusionConfig,
    DiTConfig,
    PipelineConfig,
    VAEConfig,
    dit_3b,
    dit_tiny,
    pipeline_3b,
    vae_config,
    vae_tiny,
)
