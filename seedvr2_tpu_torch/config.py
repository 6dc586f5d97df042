"""Model and pipeline configuration of the port: frozen dataclasses with the
same fields, defaults and factory functions as the JAX package's
configuration (seedvr2_tpu/config.py), kept as the port's own copy so that
the port imports nothing of the JAX package. tests/test_torch_standalone.py
holds the two equal field by field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


# --------------------------------------------------------------------------- #
# DiT
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class DiTConfig:
    """NaDiT hyperparameters (reference: configs_3b/main.yaml:13-37,
    configs_7b/main.yaml:13-36)."""

    variant: str = "3b"  # "3b" | "7b"
    vid_in_channels: int = 33  # 16 noisy + 16 cond latent + 1 mask
    vid_out_channels: int = 16
    vid_dim: int = 2560
    txt_in_dim: int = 5120
    txt_dim: int = 2560
    emb_dim: int = 15360  # 6 * vid_dim
    heads: int = 20
    head_dim: int = 128
    expand_ratio: int = 4
    norm_eps: float = 1e-5
    qk_bias: bool = False
    qk_norm: bool = True  # fusedrms on q/k per head
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_layers: int = 32
    # Layers [0, mm_layers) use separate vid/txt weights; the rest share one
    # set of weights for both streams.
    mm_layers: int = 10
    mlp_type: str = "swiglu"  # "swiglu" | "normal" (gelu-tanh)
    swiglu_multiple_of: int = 256
    window: Tuple[int, int, int] = (4, 3, 3)
    # RoPE flavour: "mmrope3d" (3B: joint vid+txt lang-style rope over the
    # full window sequence) or "window_pixel" (7B: per-window pixel rope).
    rope_type: str = "mmrope3d"
    rope_dim: int = 128
    # 3B only: extra output rms-norm + AdaLN before patch-out.
    vid_out_norm: bool = True
    # 7B: all layers keep a txt branch; 3B drops txt mlp on the last layer.
    last_layer_vid_only: bool = True
    # 3B applies a txt_in Linear(5120->2560); 7B Linear(5120->3072).
    sinusoidal_dim: int = 256

    @property
    def inner_dim(self) -> int:
        return self.heads * self.head_dim

    def shared_weights(self, layer: int) -> bool:
        return layer >= self.mm_layers

    def vid_only(self, layer: int) -> bool:
        return self.last_layer_vid_only and layer == self.num_layers - 1


def dit_3b() -> DiTConfig:
    return DiTConfig()


def dit_7b() -> DiTConfig:
    return DiTConfig(
        variant="7b",
        vid_dim=3072,
        txt_dim=3072,
        emb_dim=6 * 3072,
        heads=24,
        num_layers=36,
        mm_layers=36,  # every layer has separate vid/txt weights
        mlp_type="normal",
        rope_type="window_pixel",
        rope_dim=64,  # head_dim // 2
        vid_out_norm=False,
        last_layer_vid_only=False,
    )


def dit_tiny(rope_type: str = "mmrope3d") -> DiTConfig:
    """Small config for tests: same structure, tiny dims."""
    return DiTConfig(
        variant="tiny",
        vid_in_channels=33,
        vid_out_channels=16,
        vid_dim=64,
        txt_in_dim=48,
        txt_dim=64,
        emb_dim=6 * 64,
        heads=2,
        head_dim=32,
        num_layers=2,
        mm_layers=1,
        mlp_type="swiglu" if rope_type == "mmrope3d" else "normal",
        swiglu_multiple_of=16,
        rope_type=rope_type,
        rope_dim=32 if rope_type == "mmrope3d" else 16,
        vid_out_norm=rope_type == "mmrope3d",
        last_layer_vid_only=rope_type == "mmrope3d",
        sinusoidal_dim=32,
    )


# --------------------------------------------------------------------------- #
# VAE
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class VAEConfig:
    """Causal 3D VAE hyperparameters
    (reference: src/models/video_vae_v3/s8_c16_t4_inflation_sd3.yaml)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    temporal_scale_num: int = 2  # number of 2x temporal down/up stages
    spatial_downsample_factor: int = 8
    temporal_downsample_factor: int = 4
    slicing_sample_min_size: int = 4  # frames per temporal slice (pixel space)
    scaling_factor: float = 0.9152
    shifting_factor: float = 0.0
    mid_block_attention: bool = True  # mid-block per-frame 2D self attention
    time_receptive_field: str = "full"  # resnet conv1 is 3x3x3

    @property
    def slicing_latent_min_size(self) -> int:
        return max(1, self.slicing_sample_min_size // self.temporal_downsample_factor)

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    def encoder_temporal_down(self, i: int) -> bool:
        # Blocks i >= num_blocks - temporal_scale_num - 1 downsample time;
        # only non-final blocks have downsamplers.
        return i >= self.num_blocks - self.temporal_scale_num - 1 and i < self.num_blocks - 1

    def decoder_temporal_up(self, i: int) -> bool:
        # Up blocks i < temporal_scale_num upsample time; only non-final
        # blocks have upsamplers.
        return i < self.temporal_scale_num and i < self.num_blocks - 1


def vae_config() -> VAEConfig:
    return VAEConfig()


def vae_tiny() -> VAEConfig:
    return VAEConfig(
        latent_channels=4,
        block_out_channels=(8, 8, 16, 16),
        layers_per_block=1,
        norm_num_groups=4,
    )


# --------------------------------------------------------------------------- #
# Diffusion
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class DiffusionConfig:
    schedule_T: float = 1000.0
    prediction_type: str = "v_lerp"
    sampling_steps: int = 1  # one-step model
    cfg_scale: float = 1.0
    cfg_rescale: float = 0.0
    timestep_transform: bool = True


# --------------------------------------------------------------------------- #
# Pipeline
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end generation settings (the CLI and node parameters). The
    fields and defaults are those of the JAX package; every value of every
    field runs (pipeline/runner.py:check_supported raises ValueError only
    for an unknown colour method or output_pixfmt)."""

    dit: DiTConfig = field(default_factory=dit_3b)
    vae: VAEConfig = field(default_factory=vae_config)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)

    resolution: int = 1080
    max_resolution: int = 0
    batch_size: int = 5
    uniform_batch_size: bool = False
    temporal_overlap: int = 0
    prepend_frames: int = 0
    seed: int = 42
    input_noise_scale: float = 0.0
    latent_noise_scale: float = 0.0
    color_correction: str = "wavelet"  # lab|wavelet|wavelet_adaptive|hsv|adain|none
    encode_tiled: bool = False
    encode_tile_size: Tuple[int, int] = (1024, 1024)
    encode_tile_overlap: Tuple[int, int] = (128, 128)
    decode_tiled: bool = False
    decode_tile_size: Tuple[int, int] = (1024, 1024)
    decode_tile_overlap: Tuple[int, int] = (128, 128)
    encode_tile_batch: int = 1
    decode_tile_batch: int = 1
    compute_dtype: str = "bfloat16"
    output_bits: int = 16  # packed output codes: 16 or 8 bits a channel
    output_pixfmt: str = "rgb"  # "rgb" | "yuv420"
    fused_pipeline: str = "auto"  # "auto": one chain per batch; "off": 4 phases
    # "auto": a fused batch whose decode grid is one row of column tiles is
    # decoded and copied to the host column chunk by column chunk
    # (Runner.fused_batch_chunks); "off": one fused_batch a batch
    chunked_output: str = "auto"
    tensor_offload: str = "auto"  # "auto" | "always" | "never"
    phased_weights: bool = False

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def pipeline_3b(**kw) -> PipelineConfig:
    return PipelineConfig(dit=dit_3b(), **kw)


def pipeline_7b(**kw) -> PipelineConfig:
    return PipelineConfig(dit=dit_7b(), **kw)


def load_yaml_config(path: str) -> PipelineConfig:
    """A PipelineConfig from a YAML file (configs/3b.yaml, configs/7b.yaml),
    as the JAX package builds it: ``dit.variant`` picks 3B or 7B, and the
    flat ``diffusion`` and ``pipeline`` sections override the fields they
    name (unknown keys are ignored; tile sizes and overlaps given as lists
    become tuples). The model's architecture stays in code. ``yaml`` is
    imported here, so the port runs where it is not installed."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    variant = str(raw.get("dit", {}).get("variant", "3b")).lower()
    dit = dit_7b() if variant == "7b" else dit_3b()
    diff_kw = {k: v for k, v in (raw.get("diffusion") or {}).items() if k in DiffusionConfig.__dataclass_fields__}
    pipe_kw = {k: v for k, v in (raw.get("pipeline") or {}).items() if k in PipelineConfig.__dataclass_fields__}
    for key in ("encode_tile_size", "encode_tile_overlap", "decode_tile_size", "decode_tile_overlap"):
        if isinstance(pipe_kw.get(key), list):
            pipe_kw[key] = tuple(pipe_kw[key])
    return PipelineConfig(dit=dit, vae=vae_config(), diffusion=DiffusionConfig(**diff_kw), **pipe_kw)
