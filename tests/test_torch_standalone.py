"""The port stands alone: it imports nothing of the JAX package, and its own
copies of the JAX package's jax-free modules (configuration, window plans,
batch math, checkpoint key maps and converters, the model-name rule, the
bundled text embeddings) equal the originals.

Every comparison here is exact: the copies must give the same numbers.
"""

import ast
import dataclasses
import hashlib
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from seedvr2_tpu import config as jconfig
from seedvr2_tpu.io import registry as jregistry
from seedvr2_tpu.io import weights as jweights
from seedvr2_tpu.models.dit import windows as jwindows
from seedvr2_tpu.pipeline import batching as jbatching
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io import checkpoint, registry
from seedvr2_tpu_torch.models.dit import windows
from seedvr2_tpu_torch.pipeline import batching

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "seedvr2_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in ("seedvr2_tpu", "jax", "jaxlib")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# --------------------------------------------------------------------------- #
# Configuration
# --------------------------------------------------------------------------- #


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        out[f.name] = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
    return out


@pytest.mark.parametrize("name", ["DiTConfig", "VAEConfig", "DiffusionConfig", "PipelineConfig"])
def test_config_fields_and_defaults_equal(name):
    ours, ref = getattr(config, name), getattr(jconfig, name)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v for k, v in _defaults(ours).items()} == {
        k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v for k, v in _defaults(ref).items()
    }
    assert getattr(ours, "__dataclass_params__").frozen


@pytest.mark.parametrize(
    "factory,args",
    [("dit_3b", ()), ("dit_7b", ()), ("dit_tiny", ()), ("dit_tiny", ("window_pixel",)), ("vae_config", ()),
     ("vae_tiny", ()), ("pipeline_3b", ()), ("pipeline_7b", ())],
)
def test_config_factories_equal(factory, args):
    ours, ref = getattr(config, factory)(*args), getattr(jconfig, factory)(*args)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    dit = getattr(ours, "dit", ours)
    if isinstance(dit, config.DiTConfig):
        jdit = getattr(ref, "dit", ref)
        assert dit.inner_dim == jdit.inner_dim
        assert [(dit.shared_weights(i), dit.vid_only(i)) for i in range(dit.num_layers)] == [
            (jdit.shared_weights(i), jdit.vid_only(i)) for i in range(jdit.num_layers)
        ]
    vae = getattr(ours, "vae", ours)
    if isinstance(vae, config.VAEConfig):
        jvae = getattr(ref, "vae", ref)
        assert (vae.slicing_latent_min_size, vae.num_blocks) == (jvae.slicing_latent_min_size, jvae.num_blocks)
        assert [(vae.encoder_temporal_down(i), vae.decoder_temporal_up(i)) for i in range(vae.num_blocks)] == [
            (jvae.encoder_temporal_down(i), jvae.decoder_temporal_up(i)) for i in range(jvae.num_blocks)
        ]


def test_7b_config_is_the_published_width():
    c = config.dit_7b()
    assert (c.num_layers, c.vid_dim, c.heads, c.head_dim, c.mlp_type) == (36, 3072, 24, 128, "normal")
    assert (c.rope_type, c.rope_dim, c.vid_out_norm, c.mm_layers, c.txt_in_dim) == ("window_pixel", 64, False, 36, 5120)
    assert not any(c.shared_weights(i) or c.vid_only(i) for i in range(c.num_layers))


# --------------------------------------------------------------------------- #
# Batch math and window plans
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("uniform", [False, True])
def test_compute_batches_equal_over_a_grid(uniform):
    for total, bs, ov in itertools.product(range(1, 31), range(1, 10), range(0, 5)):
        assert batching.compute_batches(total, bs, ov, uniform) == [
            tuple(s) for s in jbatching.compute_batches(total, bs, ov, uniform)
        ], (total, bs, ov, uniform)
        assert batching.effective_overlap(bs, ov) == jbatching.effective_overlap(bs, ov)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 6, 9, 11])
def test_temporal_padding_equal(t):
    video = np.random.RandomState(t).rand(t, 2, 3, 3).astype(np.float32)
    np.testing.assert_array_equal(batching.pad_to_4n1(video), jbatching.pad_to_4n1(video))
    for count in range(0, 2 * t + 2):
        for prepend in (False, True):
            np.testing.assert_array_equal(
                batching.pad_temporal_reversed(video, count, prepend), jbatching.pad_temporal_reversed(video, count, prepend)
            )
    for spec in jbatching.compute_batches(t, 3, 0, True):
        np.testing.assert_array_equal(batching.prepare_batch(video, spec), jbatching.prepare_batch(video, spec))


def test_frames_to_4n1_equal():
    for t in range(0, 40):
        assert batching.frames_to_4n1(t) == jbatching.frames_to_4n1(t), t


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_split_frame_ranges_equal_over_a_grid(shards):
    for total, overlap in itertools.product(range(1, 41), range(0, 6)):
        assert batching.split_frame_ranges(total, shards, overlap) == [
            tuple(r) for r in jbatching.split_frame_ranges(total, shards, overlap)
        ], (total, shards, overlap)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("thw", [(1, 4, 6), (2, 6, 8), (3, 10, 14), (2, 45, 80), (5, 68, 120), (1, 1, 1)])
def test_window_plans_equal(thw, shifted):
    ours = windows.window_plan(thw, (4, 3, 3), shifted)
    ref = jwindows.window_plan(thw, (4, 3, 3), shifted)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ours.shapes == ref.shapes


# --------------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("factory,args", [("dit_tiny", ()), ("dit_tiny", ("window_pixel",)), ("dit_3b", ()), ("dit_7b", ())])
def test_dit_key_maps_equal(factory, args):
    assert checkpoint.dit_key_map(getattr(config, factory)(*args)) == jweights.dit_key_map(getattr(jconfig, factory)(*args))


@pytest.mark.parametrize("factory", ["vae_tiny", "vae_config"])
def test_vae_key_maps_equal(factory):
    assert checkpoint.vae_key_map(getattr(config, factory)()) == jweights.vae_key_map(getattr(jconfig, factory)())


def _export(tree, key_map):
    return {k: np.ascontiguousarray(v) for k, v in jweights.export_state_dict(tree, key_map).items()}


def _tree(rs):
    return {
        "blocks": [{"attn": {"qkv": {"vid": {"w": rs.randn(4, 3, 6).astype(np.float32)}}}}],
        "conv": {"w": rs.randn(3, 3, 3, 2, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32)},
        "lin": {"w": rs.randn(4, 7).astype(np.float32)},
    }


def test_flatten_and_convert_state_dict_equal(tmp_path):
    from safetensors.numpy import save_file

    tree = _tree(np.random.RandomState(0))
    key_map = {
        "blocks/0/attn/qkv/vid/w": ("blocks.0.attn.proj_qkv.vid.weight", "qkv_w"),
        "conv/w": ("c.weight", "conv3d"),
        "conv/b": ("c.bias", "none"),
        "lin/w": ("l.weight", "linear"),
    }
    flat = checkpoint.flatten_tree(tree)
    jflat = jweights.flatten_tree(tree)
    assert flat.keys() == jflat.keys() and all(flat[k] is jflat[k] for k in flat)
    state = _export(tree, key_map)
    save_file(state, str(tmp_path / "m.safetensors"))
    loaded = checkpoint.load_safetensors(str(tmp_path / "m.safetensors"))
    jloaded = jweights.load_safetensors(str(tmp_path / "m.safetensors"))
    ours, ref = checkpoint.convert_state_dict(loaded, key_map), jweights.convert_state_dict(jloaded, key_map)
    assert ours.keys() == ref.keys()
    for k in ours:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
        np.testing.assert_array_equal(ours[k], flat[k])
    with pytest.raises(KeyError):
        checkpoint.convert_state_dict({}, key_map)


def test_load_safetensors_reads_bf16_like_the_jax_package(tmp_path):
    from safetensors.torch import save_file

    t = {"a": torch.randn(3, 4).bfloat16(), "b": torch.randn(5).half()}
    save_file(t, str(tmp_path / "m.safetensors"))
    ours = checkpoint.load_safetensors(str(tmp_path / "m.safetensors"))
    ref = jweights.load_safetensors(str(tmp_path / "m.safetensors"))
    for k in t:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_bundled_text_embeddings_are_a_byte_identical_copy():
    digest = [hashlib.sha256(p.read_bytes()).hexdigest() for p in (
        REPO / "seedvr2_tpu_torch" / "assets" / "text_embeddings.npz",
        REPO / "seedvr2_tpu" / "assets" / "text_embeddings.npz",
    )]
    assert digest[0] == digest[1]
    (pos, neg), (jpos, jneg) = checkpoint.load_text_embeddings(), jweights.load_text_embeddings()
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(neg, jneg)
    assert pos.shape == (58, 5120)


def test_text_embeddings_from_a_directory(tmp_path):
    pos, neg = np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32)
    np.savez(tmp_path / "text_embeddings.npz", pos=pos, neg=neg)
    for got, ref in zip(checkpoint.load_text_embeddings(str(tmp_path)), jweights.load_text_embeddings(str(tmp_path))):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize(
    "name",
    ["seedvr2_ema_3b_fp16.safetensors", "seedvr2_ema_7b_fp16.safetensors", "SEEDVR2_EMA_7B_sharp.safetensors",
     "tiny_dit.safetensors", "tiny_7b.safetensors", "ema_vae_fp16.safetensors", "model.gguf"],
)
def test_model_variant_equal(name):
    assert registry.model_variant(name) == jregistry.model_variant(name)
