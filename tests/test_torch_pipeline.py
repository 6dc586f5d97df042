"""The whole ported slice vs the JAX package: phases.generate on vae_tiny +
dit_tiny (vid_in_channels = 2 * latent + 1), compute_dtype float32, the same
weights, text embedding and DiT noise (JAX's draw, handed to the port).

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

from seedvr2_tpu.config import PipelineConfig, dit_tiny, vae_tiny
from seedvr2_tpu.io import weights as jweights
from seedvr2_tpu.models.dit.nadit import init_params as init_dit
from seedvr2_tpu.models.vae.model import init_vae_params
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu.pipeline.runner import Runner as JRunner
from seedvr2_tpu.utils.seed import batch_key
from seedvr2_tpu_torch.io.weights import dit_from_jax, vae_from_jax
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.pipeline.loader import load_runner
from seedvr2_tpu_torch.pipeline.runner import Runner

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    vc = vae_tiny()
    dc = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    return PipelineConfig(dit=dc, vae=vc, resolution=32, batch_size=5, compute_dtype="float32", **kw)


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
    ref = jphases.generate(JRunner(cfg, jax.tree.map(jax.numpy.asarray, dit_p), jax.tree.map(jax.numpy.asarray, vae_p), text), frames, packed=packed)
    runner = Runner(cfg, dit_from_jax(dit_p, cfg.dit, "cpu", torch.float32), vae_from_jax(vae_p, cfg.vae, "cpu", torch.float32), text, device="cpu")
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
    runner = load_runner("tiny_dit.safetensors", "tiny_vae.safetensors", str(tmp_path), cfg, device="cpu")
    pos, _ = jweights.load_text_embeddings()
    frames = _frames(5, seed=4)
    ref = jphases.generate(JRunner(cfg, jax.tree.map(jax.numpy.asarray, dit_p), jax.tree.map(jax.numpy.asarray, vae_p), pos[:, : cfg.dit.txt_in_dim]), frames)
    got = phases.generate(runner, frames, noise=torch.from_numpy(_jax_noise(cfg, frames)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "kw",
    [
        dict(temporal_overlap=2),
        dict(encode_tiled=True),
        dict(color_correction="lab"),
        dict(prepend_frames=2),
        dict(output_pixfmt="yuv420"),
    ],
)
def test_settings_off_the_ported_path_raise(setup, kw):
    cfg, dit_p, vae_p, text = setup
    runner = Runner(cfg, dit_from_jax(dit_p, cfg.dit, "meta", torch.float32), vae_from_jax(vae_p, cfg.vae, "meta", torch.float32), text, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        phases.generate(runner, _frames(5), cfg.replace(**kw))


def test_settings_off_the_ported_path_raise_rgba_and_quantize(setup, tmp_path):
    cfg, dit_p, vae_p, text = setup
    runner = Runner(cfg, dit_from_jax(dit_p, cfg.dit, "meta", torch.float32), vae_from_jax(vae_p, cfg.vae, "meta", torch.float32), text, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        phases.generate(runner, np.zeros((5, 8, 8, 4), np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_runner("a.safetensors", "b.safetensors", str(tmp_path), cfg, device="cpu", quantize="int8")


def test_port_runs_without_jax():
    """A fresh interpreter (no sitecustomize, no conftest) imports the port,
    runs a tiny random-weight upscale, and never imports jax."""
    code = """
import dataclasses, sys, numpy as np, torch
from seedvr2_tpu.config import PipelineConfig, dit_tiny, vae_tiny
from seedvr2_tpu_torch.io.weights import random_dit, random_vae
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.pipeline.runner import Runner
vc = vae_tiny()
dc = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
cfg = PipelineConfig(dit=dc, vae=vc, resolution=16, compute_dtype="float32")
g = torch.Generator().manual_seed(0)
r = Runner(cfg, random_dit(dc, g, torch.float32), random_vae(vc, g, torch.float32), np.zeros((3, dc.txt_in_dim), np.float32), device="cpu")
out = phases.generate(r, np.random.RandomState(0).rand(5, 12, 12, 3).astype(np.float32))
assert out.shape == (5, 16, 16, 3) and np.isfinite(out).all()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-2000:]
