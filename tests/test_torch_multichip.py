"""Frame-parallel generation and the tile-parallel VAE of the port on two gloo
ranks (CPU) vs the JAX package on its 8-device CPU mesh (conftest), with
the same weights (the JAX init perturbed), text, frames and DiT noise (the
JAX draw, handed to the port), fp32, dit_tiny + vae_tiny:

- generate_multichip with data=2 (segments with seams, Hann blend;
  prepended frames and a cross-frame colour method) against JAX's
  generate_multichip(make_mesh(data=2)), and its fallback (< 2 frames per
  rank: phases.generate on every rank, the tiles of a tiled VAE split over
  the ranks); phases.generate on a tensor=2 mesh (no data axis);
- the tile-parallel tiled decode against JAX's tile-sharded decode
  (tests/test_tile_sharding.py), on 3 ranks with 2 tiles against JAX's
  unsharded tiled decode, and a mesh Runner's tiled encode and
  decode against JAX's mesh Runner.

Bounds: pipeline outputs atol=1e-4 of [0, 1], as tests/test_torch_pipeline.py
holds the unsharded slice (16-bit codes); VAE outputs atol=rtol=5e-4, as
tests/test_torch_tiling.py.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_worker as ranks
from seedvr2_tpu.config import PipelineConfig, dit_tiny, vae_tiny
from seedvr2_tpu.io.weights import flatten_tree
from seedvr2_tpu.models.dit.nadit import init_params as init_dit
from seedvr2_tpu.models.vae import tiling as jtiling
from seedvr2_tpu.models.vae.model import init_vae_params
from seedvr2_tpu.ops.resize import side_resize_dims
from seedvr2_tpu.parallel.mesh import make_mesh as j_make_mesh
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu.pipeline.multichip import generate_multichip as j_generate_multichip
from seedvr2_tpu.pipeline.runner import Runner as JRunner
from seedvr2_tpu.utils.seed import batch_key
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io.weights import dit_from_jax, vae_from_jax
from seedvr2_tpu_torch.parallel.mesh import Mesh
from seedvr2_tpu_torch.pipeline.multichip import generate_multichip
from seedvr2_tpu_torch.pipeline.runner import Runner

ATOL = 1e-4
VAE_TOL = dict(atol=5e-4, rtol=5e-4)
TILED = dict(encode_tiled=True, decode_tiled=True, encode_tile_size=(32, 32), encode_tile_overlap=(8, 8),
             decode_tile_size=(32, 32), decode_tile_overlap=(8, 8))


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


def _cfg(**kw):
    vc = vae_tiny()
    dc = dataclasses.replace(dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    return PipelineConfig(dit=dc, vae=vc, resolution=32, batch_size=5, compute_dtype="float32", **kw)


def _frames(t, seed):
    return np.random.RandomState(seed).rand(t, 24, 20, 3).astype(np.float32)


def _jax_noise(cfg, frames):
    """The JAX step's per-batch base noise (one draw for every batch and
    segment: split(batch_key(seed, 'dit')) -> normal(k1, latent.shape[1:]))."""
    h, w = side_resize_dims(frames.shape[1], frames.shape[2], cfg.resolution, cfg.max_resolution)
    per = (2, -(-h // 16) * 2, -(-w // 16) * 2, cfg.vae.latent_channels)  # 5-frame batches: 2 latent frames
    k1, _ = jax.random.split(batch_key(cfg.seed, "dit"))
    return np.array(jax.random.normal(k1, per, np.float32))


DIT = _perturbed(init_dit(_cfg().dit, jax.random.PRNGKey(0)), 1)
VAE = _perturbed(init_vae_params(_cfg().vae, jax.random.PRNGKey(1)), 2)
TEXT = (np.random.RandomState(3).randn(4, _cfg().dit.txt_in_dim) * 0.1).astype(np.float32)
Z = (np.random.RandomState(4).randn(1, 2, 8, 8, vae_tiny().latent_channels) * 0.5).astype(np.float32)
Z_IDLE = (np.random.RandomState(10).randn(1, 2, 4, 7, vae_tiny().latent_channels) * 0.5).astype(np.float32)
VIDEO = (np.random.RandomState(5).randn(1, 5, 64, 48, 3) * 0.4).astype(np.float32)

# name -> (pipeline settings, frames, seam overlap)
GENERATE = {
    "seams": (dict(), _frames(20, 6), 3),
    "prepend_adain": (dict(prepend_frames=2, color_correction="adain"), _frames(12, 7), 3),
    "fallback_tiled": (TILED, _frames(3, 8), 4),
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("multichip")
    inputs = {"text": TEXT, "z": Z, "video": VIDEO}
    inputs.update({f"dit/{k}": v for k, v in flatten_tree(DIT).items()})
    inputs.update({f"vae/{k}": v for k, v in flatten_tree(VAE).items()})
    cases = []
    for name, (kw, frames, seam) in GENERATE.items():
        inputs[f"frames/{name}"] = frames
        inputs[f"noise/{name}"] = _jax_noise(_cfg(**kw), frames)
        cases.append(dict(name=name, kind="generate", pipeline=dict(resolution=32, batch_size=5,
                                                                    compute_dtype="float32", **kw),
                          frames=f"frames/{name}", noise=f"noise/{name}", seam_overlap=seam))
    inputs["frames/tensor"] = _frames(5, 9)
    inputs["noise/tensor"] = _jax_noise(_cfg(), inputs["frames/tensor"])
    cases.append(dict(name="generate_tensor", kind="generate_tensor", frames="frames/tensor", noise="noise/tensor",
                      pipeline=dict(resolution=32, batch_size=5, compute_dtype="float32")))
    cases.append(dict(name="tiled_decode", kind="tiled_decode", z="z", tile_size=[32, 32], tile_overlap=[8, 8],
                      tile_batch=2))
    cases.append(dict(name="runner_vae", kind="runner_vae", video="video",
                      pipeline=dict(resolution=32, compute_dtype="float32", **TILED)))
    np.savez(d / "inputs.npz", **inputs)
    (d / "cases.json").write_text(json.dumps(cases))
    # 3 ranks, 2 tiles: rank 2 holds none
    d3 = tmp_path_factory.mktemp("multichip3")
    np.savez(d3 / "inputs.npz", z_idle=Z_IDLE, **{k: v for k, v in inputs.items() if k.split("/")[0] in
                                                  ("text", "dit", "vae")})
    (d3 / "cases.json").write_text(json.dumps([dict(name="tiled_decode_idle", kind="tiled_decode", z="z_idle",
                                                    tile_size=[32, 32], tile_overlap=[8, 8], tile_batch=1)]))
    procs = [(ranks.start("multichip", d, 2), d, 2), (ranks.start("multichip", d3, 3), d3, 3)]
    try:
        out = ranks.finish(*procs[0])
        out["tiled_decode_idle"] = ranks.finish(*procs[1])["tiled_decode_idle"]
        yield out
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _jax_runner(cfg, mesh=None):
    return JRunner(cfg, jax.tree.map(jnp.asarray, DIT), jax.tree.map(jnp.asarray, VAE), TEXT, mesh=mesh)


@pytest.mark.parametrize("name", list(GENERATE))
def test_generate_multichip_matches_jax(port, name):
    """seams: 20 frames -> segments [0, 13) and [10, 20), a 3-frame blend;
    prepend_adain: 12 + 2 prepended frames, a colour method whose
    statistics span frames; fallback_tiled: 3 frames on data=2."""
    kw, frames, seam = GENERATE[name]
    mesh = j_make_mesh(data=2)
    ref = j_generate_multichip(_jax_runner(_cfg(**kw), mesh), frames, mesh, seam_overlap=seam)
    got = port[name]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_generate_on_a_tensor_mesh_matches_jax(port):
    """No data axis: phases.generate on every rank, the DiT split over
    tensor=2 (K3s per rank), against JAX's phases.generate with a
    make_mesh(1, 1, 2) runner (its sharding hints on)."""
    frames = _frames(5, 9)
    ref = jphases.generate(_jax_runner(_cfg(), j_make_mesh(1, 1, 2)), frames)
    np.testing.assert_allclose(port["generate_tensor"], ref, atol=ATOL, rtol=0)


def test_tile_parallel_decode_matches_jax_tile_sharded(port):
    cfg = vae_tiny()
    shard = jax.sharding.NamedSharding(j_make_mesh(data=2), jax.sharding.PartitionSpec("data"))
    ref = jtiling.tiled_decode(jax.tree.map(jnp.asarray, VAE), cfg, jnp.asarray(Z), tile_size=(32, 32),
                               tile_overlap=(8, 8), tile_batch=2, tile_sharding=shard)
    np.testing.assert_allclose(port["tiled_decode"], np.asarray(ref), **VAE_TOL)


def test_tile_parallel_decode_with_an_idle_rank_matches_jax(port):
    """2 tiles on 3 ranks: the rank without a tile adds a zero accumulator
    (no VAE pass), the sum equals JAX's unsharded tiled decode."""
    ref = jtiling.tiled_decode(jax.tree.map(jnp.asarray, VAE), vae_tiny(), jnp.asarray(Z_IDLE), tile_size=(32, 32),
                               tile_overlap=(8, 8), tile_batch=1)
    assert port["tiled_decode_idle"].shape == ref.shape
    np.testing.assert_allclose(port["tiled_decode_idle"], np.asarray(ref), **VAE_TOL)


def test_mesh_runner_tiled_vae_matches_jax(port):
    runner = _jax_runner(_cfg(**TILED), j_make_mesh(data=2))
    lat = runner.vae_encode(jnp.asarray(VIDEO))
    np.testing.assert_allclose(port["runner_vae/latent"], np.asarray(lat), **VAE_TOL)
    np.testing.assert_allclose(port["runner_vae/decoded"], np.asarray(runner.vae_decode(lat)), **VAE_TOL)


@pytest.mark.parametrize("name,frames,factory", [("auto_3b_clip", 10, "dit_3b"), ("auto_7b_image", 1, "dit_7b")])
def test_build_mesh_picks_the_jax_entry_points_mesh(port, name, frames, factory):
    """build_mesh("auto") on 2 ranks: the JAX CLI's choice (auto_mesh_shape
    with the heads and bf16 DiT bytes, 16 GiB of memory for a CPU device as
    the JAX package assumes); "d,s,t" as given."""
    from seedvr2_tpu import config as jconfig
    from seedvr2_tpu.parallel.mesh import auto_mesh_shape
    from seedvr2_tpu.pipeline.loader import dit_param_bytes

    cfg = getattr(jconfig, factory)()
    want = auto_mesh_shape(2, frames, cfg.heads, dit_param_bytes(cfg), 16 << 30)
    assert tuple(port[f"build_mesh/{name}"]) == want
    assert tuple(port["build_mesh/given"]) == (1, 1, 2)


@pytest.mark.parametrize("kw,channels", [(dict(), 4), (dict(input_noise_scale=0.1), 3)])
def test_generate_multichip_raises_off_the_ported_path(kw, channels):
    """RGBA and noise augmentation raise as in phases.generate, before any
    collective (so one process and a mesh object suffice)."""
    pc = config.PipelineConfig(**{k: getattr(_cfg(), k) for k in ("resolution", "batch_size", "compute_dtype")},
                               dit=config.DiTConfig(**dataclasses.asdict(_cfg().dit)),
                               vae=config.VAEConfig(**dataclasses.asdict(_cfg().vae)))
    runner = Runner(pc, dit_from_jax(DIT, pc.dit, "meta", torch.float32), vae_from_jax(VAE, pc.vae, "meta", torch.float32),
                    TEXT, device="cpu")
    runner.cfg = pc.replace(**kw)
    mesh = Mesh({"data": 2, "seq": 1, "tensor": 1}, 0, {}, None, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        generate_multichip(runner, np.zeros((6, 8, 8, channels), np.float32), mesh)
