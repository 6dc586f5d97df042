"""The whole ported slice vs the JAX package: phases.generate on vae_tiny +
dit_tiny (vid_in_channels = 2 * latent + 1), compute_dtype float32, the same
weights, text embedding and DiT noise (JAX's draw, handed to the port). The
3B-style tiny DiT runs the default attention; the 7B-style one
(window_pixel) runs under fused, sageattn_2 (K3q) and flash_attn_2 (K5).
The port is given its own config objects with the JAX ones' field values.

Outputs are compared as float32 in [0, 1] after both packages quantise to
16-bit codes: a code flips where fp32 summation order moves a value across
a rounding boundary (1 code measured), so the bound is atol=1e-4 (6.5 codes).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.config import PipelineConfig, dit_tiny, vae_tiny
from seedvr2_tpu.io import weights as jweights
from seedvr2_tpu.ops.attention import get_attention_backend, set_attention_backend
from seedvr2_tpu.models.dit.nadit import init_params as init_dit
from seedvr2_tpu.models.vae.model import init_vae_params
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu.pipeline.runner import Runner as JRunner
from seedvr2_tpu.utils.seed import batch_key
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io.weights import dit_from_jax, vae_from_jax
from seedvr2_tpu_torch.pipeline import loader
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.pipeline.loader import load_runner
from seedvr2_tpu_torch.pipeline.runner import Runner

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(rope_type="mmrope3d", **kw):
    vc = vae_tiny()
    dc = dataclasses.replace(dit_tiny(rope_type), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    return PipelineConfig(dit=dc, vae=vc, resolution=32, batch_size=5, compute_dtype="float32", **kw)


def _port_cfg(rope_type="mmrope3d", **kw):
    """The port's own PipelineConfig with the same field values as _cfg."""
    vc = config.vae_tiny()
    dc = dataclasses.replace(
        config.dit_tiny(rope_type), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels
    )
    cfg = config.PipelineConfig(dit=dc, vae=vc, resolution=32, batch_size=5, compute_dtype="float32", **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_cfg(rope_type, **kw))
    return cfg


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    dit_p = _perturbed(init_dit(cfg.dit, jax.random.PRNGKey(0)), 1)
    vae_p = _perturbed(init_vae_params(cfg.vae, jax.random.PRNGKey(1)), 2)
    text = (np.random.RandomState(3).randn(4, cfg.dit.txt_in_dim) * 0.1).astype(np.float32)
    return cfg, dit_p, vae_p, text


@pytest.fixture(scope="module")
def setup_7b_style():
    cfg = _cfg("window_pixel")
    dit_p = _perturbed(init_dit(cfg.dit, jax.random.PRNGKey(4)), 5)
    vae_p = _perturbed(init_vae_params(cfg.vae, jax.random.PRNGKey(1)), 2)
    text = (np.random.RandomState(6).randn(5, cfg.dit.txt_in_dim) * 0.1).astype(np.float32)
    return cfg, dit_p, vae_p, text


def _jax_generate(cfg, dit_p, vae_p, text, frames, mode="fused", **kw):
    prev = get_attention_backend()
    set_attention_backend(mode)
    try:
        return jphases.generate(
            JRunner(cfg, jax.tree.map(jax.numpy.asarray, dit_p), jax.tree.map(jax.numpy.asarray, vae_p), text), frames, **kw
        )
    finally:
        set_attention_backend(prev)


def _frames(t, seed=0, h=24, w=20):
    return np.random.RandomState(seed).rand(t, h, w, 3).astype(np.float32)


def _jax_noise(cfg, frames):
    """The JAX step's per-batch base noise (runner.py: split(batch_key(seed,
    'dit')) -> normal(k1, latent.shape[1:]))."""
    from seedvr2_tpu.ops.resize import side_resize_dims

    h, w = side_resize_dims(frames.shape[1], frames.shape[2], cfg.resolution, cfg.max_resolution)
    per = (2, -(-h // 16) * 2, -(-w // 16) * 2, cfg.vae.latent_channels)  # 5-frame batch: 2 latent frames
    k1, _ = jax.random.split(batch_key(cfg.seed, "dit"))
    return np.array(jax.random.normal(k1, per, np.float32))


@pytest.mark.parametrize("t,packed", [(5, False), (9, False), (9, True)])
def test_generate_matches_jax(setup, t, packed):
    """9 frames = two batches, the second padded from 4 to 5 frames."""
    cfg, dit_p, vae_p, text = setup
    frames = _frames(t)
    ref = _jax_generate(cfg, dit_p, vae_p, text, frames, packed=packed)
    pc = _port_cfg()
    runner = Runner(pc, dit_from_jax(dit_p, pc.dit, "cpu", torch.float32), vae_from_jax(vae_p, pc.vae, "cpu", torch.float32), text, device="cpu")
    got = phases.generate(runner, frames, packed=packed, noise=torch.from_numpy(_jax_noise(cfg, frames)))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if packed:
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= ATOL * 65535
    else:
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_load_runner_from_safetensors_matches_jax(setup, tmp_path):
    """Tiny checkpoints exported in the reference's torch layout, loaded
    through load_runner with the bundled text embedding (cut to the tiny
    text width, as the JAX loader does)."""
    from safetensors.numpy import save_file

    cfg, dit_p, vae_p, _ = setup
    for name, p, km in (("tiny_dit.safetensors", dit_p, jweights.dit_key_map(cfg.dit)), ("tiny_vae.safetensors", vae_p, jweights.vae_key_map(cfg.vae))):
        save_file({k: np.ascontiguousarray(v) for k, v in jweights.export_state_dict(p, km).items()}, str(tmp_path / name))
    runner = load_runner("tiny_dit.safetensors", "tiny_vae.safetensors", str(tmp_path), _port_cfg(), device="cpu")
    pos, _ = jweights.load_text_embeddings()
    frames = _frames(5, seed=4)
    ref = _jax_generate(cfg, dit_p, vae_p, pos[:, : cfg.dit.txt_in_dim], frames)
    got = phases.generate(runner, frames, noise=torch.from_numpy(_jax_noise(cfg, frames)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["fused", "sageattn_2", "flash_attn_2"])
def test_generate_7b_style_matches_jax_under_each_attention_mode(setup_7b_style, mode):
    """window_pixel tiny DiT (GELU, no text RoPE, separate weights in every
    layer, no vid_out_norm); 9 frames = two batches."""
    cfg, dit_p, vae_p, text = setup_7b_style
    frames = _frames(9, seed=8)
    ref = _jax_generate(cfg, dit_p, vae_p, text, frames, mode)
    pc = _port_cfg("window_pixel")
    dit = dit_from_jax(dit_p, pc.dit, "cpu", torch.float32).set_attention_mode(mode)
    runner = Runner(pc, dit, vae_from_jax(vae_p, pc.vae, "cpu", torch.float32), text, device="cpu")
    got = phases.generate(runner, frames, noise=torch.from_numpy(_jax_noise(cfg, frames)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_load_runner_picks_7b_from_the_file_name(setup_7b_style, tmp_path, monkeypatch):
    """A "7b" name turns a 3B config into dit_7b(), as the JAX loader does;
    dit_7b is swapped for the 7B-style tiny config (labelled "7b") so that
    the checkpoint stays small. The bundled [58, 5120]-wide text embedding
    is cut to the tiny text width, as the JAX loader cuts it."""
    from safetensors.numpy import save_file

    cfg, dit_p, vae_p, _ = setup_7b_style
    for name, p, km in (("seedvr2_ema_7b_fp16.safetensors", dit_p, jweights.dit_key_map(cfg.dit)),
                        ("tiny_vae.safetensors", vae_p, jweights.vae_key_map(cfg.vae))):
        save_file({k: np.ascontiguousarray(v) for k, v in jweights.export_state_dict(p, km).items()}, str(tmp_path / name))
    small_7b = dataclasses.replace(_port_cfg("window_pixel").dit, variant="7b")
    monkeypatch.setattr(loader, "dit_7b", lambda: small_7b)
    port_3b = _port_cfg().replace(dit=dataclasses.replace(_port_cfg().dit, variant="3b"))
    runner = load_runner("seedvr2_ema_7b_fp16.safetensors", "tiny_vae.safetensors", str(tmp_path), port_3b,
                         device="cpu", attention_mode="flash_attn_2")
    assert runner.cfg.dit == small_7b and runner.dit.attention_backend == "pallas"
    pos, _ = jweights.load_text_embeddings()
    frames = _frames(5, seed=9)
    ref = _jax_generate(cfg, dit_p, vae_p, pos[:, : cfg.dit.txt_in_dim], frames, "flash_attn_2")
    got = phases.generate(runner, frames, noise=torch.from_numpy(_jax_noise(cfg, frames)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "name,variant", [("seedvr2_ema_7b_fp16.safetensors", "7b"), ("seedvr2_ema_3b_fp16.safetensors", "3b"), ("x.safetensors", "3b")]
)
def test_load_runner_variant_rule(tmp_path, name, variant):
    """Without a cfg the file name alone picks the full-width config; a
    3B/7B cfg is corrected to the name, a custom one is kept. Loading a
    missing file with ``download=False`` raises after the choice; an
    unknown attention mode raises before any file is read."""
    want = config.dit_7b() if variant == "7b" else config.dit_3b()
    assert loader.pick_config(name).dit == want
    assert loader.pick_config(name).vae == config.vae_config()
    for start in (config.pipeline_3b(resolution=720), config.pipeline_7b(resolution=720)):
        picked = loader.pick_config(name, start)
        assert picked.dit == want and picked.resolution == 720
    assert loader.pick_config(name, _port_cfg()) == _port_cfg()
    with pytest.raises(FileNotFoundError, match=name):
        load_runner(name, "ema_vae_fp16.safetensors", str(tmp_path), device="cpu", download=False)
    with pytest.raises(ValueError, match="Unknown attention backend"):
        load_runner(name, "ema_vae_fp16.safetensors", str(tmp_path), device="cpu", attention_mode="flash")


def test_int8_and_gguf_settings_load_a_runner(setup, tmp_path, monkeypatch):
    """The two settings that raised before int8 weights were ported:
    ``quantize="int8"`` on a safetensors DiT and a .gguf DiT now give a
    Runner with int8 block linears (the threshold lowered to the tiny
    widths; tests/test_torch_quant.py and tests/test_torch_gguf.py hold
    their forwards against the JAX package)."""
    from safetensors.numpy import save_file

    from seedvr2_tpu_torch.io import gguf
    from seedvr2_tpu_torch.ops import quant

    monkeypatch.setattr(quant, "_QUANT_MIN_SIZE", 1024)

    cfg, dit_p, vae_p, _ = setup
    dit_sd = {k: np.ascontiguousarray(v) for k, v in jweights.export_state_dict(dit_p, jweights.dit_key_map(cfg.dit)).items()}
    save_file(dit_sd, str(tmp_path / "a.safetensors"))
    gguf.write_gguf(str(tmp_path / "a.gguf"), {k: (v, gguf.F32) for k, v in dit_sd.items()})
    save_file({k: np.ascontiguousarray(v) for k, v in jweights.export_state_dict(vae_p, jweights.vae_key_map(cfg.vae)).items()},
              str(tmp_path / "b.safetensors"))
    pc = _port_cfg()
    for runner in (load_runner("a.safetensors", "b.safetensors", str(tmp_path), pc, device="cpu", quantize="int8"),
                   load_runner("a.gguf", "b.safetensors", str(tmp_path), pc, device="cpu")):
        assert isinstance(runner, Runner) and runner.dit.quantize == "int8"
    with pytest.raises(ValueError, match="int8"):
        load_runner("a.safetensors", "b.safetensors", str(tmp_path), pc, device="cpu", quantize="fp8")


def test_port_runs_without_jax():
    """A fresh interpreter (no sitecustomize, no conftest) imports only the
    port, runs tiny random-weight upscales (3B-style and 7B-style, every
    attention mode, the bundled text embedding) and the CLI on an RGBA
    image, and never imports jax or any module of the JAX package."""
    code = """
import dataclasses, sys, numpy as np, torch
from seedvr2_tpu_torch.config import PipelineConfig, dit_tiny, vae_tiny
from seedvr2_tpu_torch.io.weights import load_text_embeddings, random_dit, random_vae
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.pipeline.runner import Runner
vc = vae_tiny()
text = load_text_embeddings()[0][:5, :48]
for rope, mode in (("mmrope3d", "fused"), ("window_pixel", "sageattn_2"), ("window_pixel", "flash_attn_2"), ("window_pixel", "sdpa")):
    dc = dataclasses.replace(dit_tiny(rope), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    cfg = PipelineConfig(dit=dc, vae=vc, resolution=16, compute_dtype="float32")
    g = torch.Generator().manual_seed(0)
    r = Runner(cfg, random_dit(dc, g, torch.float32).set_attention_mode(mode), random_vae(vc, g, torch.float32), text, device="cpu")
    out = phases.generate(r, np.random.RandomState(0).rand(5, 12, 12, 3).astype(np.float32))
    assert out.shape == (5, 16, 16, 3) and np.isfinite(out).all()
import tempfile
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.io import video
from seedvr2_tpu_torch.io.weights import save_random_checkpoint
with tempfile.TemporaryDirectory() as d:
    dc = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    save_random_checkpoint(d + "/tiny_dit.safetensors", "dit", dc, torch.Generator().manual_seed(0), torch.float32)
    save_random_checkpoint(d + "/tiny_vae.safetensors", "vae", vc, torch.Generator().manual_seed(1), torch.float32)
    video.write_image(d + "/in.png", np.random.RandomState(1).rand(12, 12, 4).astype(np.float32))
    assert cli.main([d + "/in.png", "--model_dir", d, "--dit_model", "tiny_dit.safetensors", "--vae_model",
                     "tiny_vae.safetensors", "--resolution", "16", "--cuda_device", "cpu", "--debug"]) == 0
    assert video.read_image(d + "/in_upscaled.png").shape == (16, 16, 4)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "seedvr2_tpu"))
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-2000:]
