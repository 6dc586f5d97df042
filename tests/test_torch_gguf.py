"""GGUF and .pth checkpoints in the port (seedvr2_tpu_torch/io/gguf.py,
io/checkpoint.py, the loader's int8 and format rules, the mesh's weight
bytes, the CLI's --quantize int8 and .gguf DiTs) against the JAX package
on the same files and numpy inputs, fp32 on the CPU.

Dequantization and the readers are held bit-equal to seedvr2_tpu/io/gguf.py
and seedvr2_tpu/io/weights.py:load_pth. Forwards are held at
test_torch_dit.py's tolerance (atol=2e-4, rtol=1e-3), whole upscales at
test_torch_pipeline.py's (atol=1e-4 of [0, 1]). The tiny configs' block
linears are below the 65,536-element threshold, so the int8 cases set
both packages' _QUANT_MIN_SIZE to 1024 (every block linear of dit_tiny).
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inference_cli
from seedvr2_tpu import config as jconfig
from seedvr2_tpu.io import gguf as J
from seedvr2_tpu.io import weights as jweights
from seedvr2_tpu.models.dit import nadit as jnadit
from seedvr2_tpu.models.vae.model import init_vae_params
from seedvr2_tpu.ops import quant as jquant
from seedvr2_tpu.pipeline import loader as jloader
from seedvr2_tpu.pipeline import phases as jphases
from seedvr2_tpu.utils.seed import batch_key
from seedvr2_tpu_torch import cli, config
from seedvr2_tpu_torch.io import checkpoint
from seedvr2_tpu_torch.io import gguf as G
from seedvr2_tpu_torch.models.dit import nadit
from seedvr2_tpu_torch.ops import quant
from seedvr2_tpu_torch.parallel import mesh
from seedvr2_tpu_torch.pipeline import loader, phases

TOL = dict(atol=2e-4, rtol=1e-3)
ATOL = 1e-4
MIN_SIZE = 1024

# (type, elements a block, bytes a block, byte spans of its f16 scales)
BLOCK_CASES = [
    ("F32", 1, 4, []), ("F16", 1, 2, []), ("BF16", 1, 2, []),
    ("Q4_0", 32, 18, [(0, 2)]), ("Q4_1", 32, 20, [(0, 2), (2, 4)]), ("Q5_0", 32, 22, [(0, 2)]),
    ("Q5_1", 32, 24, [(0, 2), (2, 4)]), ("Q8_0", 32, 34, [(0, 2)]), ("Q2_K", 256, 84, [(80, 82), (82, 84)]),
    ("Q3_K", 256, 110, [(108, 110)]), ("Q4_K", 256, 144, [(0, 2), (2, 4)]), ("Q5_K", 256, 176, [(0, 2), (2, 4)]),
    ("Q6_K", 256, 210, [(208, 210)]),
]


def test_block_table_is_the_jax_one():
    assert G._BLOCK == J._BLOCK and {n: getattr(G, n) for n, *_ in BLOCK_CASES} == {n: getattr(J, n)
                                                                                   for n, *_ in BLOCK_CASES}


@pytest.mark.parametrize("name,belems,bbytes,scales", BLOCK_CASES)
def test_every_block_type_dequantizes_as_jax(name, belems, bbytes, scales):
    """Random blocks with sane f16 scales (random bytes can encode inf/nan;
    the float types get finite values), bit-equal to the JAX dequant."""
    nb = 16
    rs = np.random.RandomState(len(name) * 31 + bbytes)
    if name in ("F32", "F16", "BF16"):
        vals = rs.randn(nb * belems).astype(np.float32)
        raw = {"F32": vals, "F16": vals.astype(np.float16), "BF16": (vals.view(np.uint32) >> 16).astype(np.uint16)}[name]
        raw = raw.view(np.uint8)
    else:
        blocks = rs.randint(0, 256, (nb, bbytes)).astype(np.uint8)
        for i in range(nb):
            for j, (lo, hi) in enumerate(scales):
                blocks[i, lo:hi] = np.frombuffer(np.float16(0.37 * (i + 1) * (0.5 if j else 1.0)).tobytes(), np.uint8)
        raw = blocks.reshape(-1)
    gtype = getattr(G, name)
    got = G.dequantize(raw.copy(), gtype, nb * belems)
    ref = J.dequantize(raw.copy(), gtype, nb * belems)
    assert got.dtype == ref.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_written_gguf_reads_back(tmp_path):
    """F32, F16 and Q8_0 tensors and string metadata: the port's reader and
    the JAX package's read the same header and values; F32 exactly, F16 to
    its rounding, Q8_0 to half a step of its block scale."""
    rs = np.random.RandomState(0)
    a, b, c = rs.randn(6, 64).astype(np.float32), rs.randn(7).astype(np.float32), rs.randn(3, 5).astype(np.float32)
    path = str(tmp_path / "t.gguf")
    G.write_gguf(path, {"blocks.0.w": (a, G.Q8_0), "bias": (b, G.F32), "h": (c, G.F16)},
                 {"general.architecture": "seedvr2"})
    g, jg = G.read_gguf(path), J.read_gguf(path)
    assert g.metadata == jg.metadata == {"general.alignment": 32, "general.architecture": "seedvr2"}
    assert g.tensors == jg.tensors and g.data_start == jg.data_start
    ours, ref = G.load_gguf_state_dict(path), J.load_gguf_state_dict(path)
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_array_equal(ours["bias"], b)
    np.testing.assert_array_equal(ours["h"], c.astype(np.float16).astype(np.float32))
    step = np.abs(a.reshape(-1, 32)).max(1, keepdims=True) / 127
    assert (np.abs(ours["blocks.0.w"].reshape(-1, 32) - a.reshape(-1, 32)) <= 0.51 * step + 1e-3 * step).all()
    assert G.validate_gguf_architecture(path, ["bias", "x"]) == J.validate_gguf_architecture(path, ["bias", "x"]) == ["x"]
    with pytest.raises(ValueError, match="Q8_0"):
        G.write_gguf(str(tmp_path / "bad.gguf"), {"x": (np.ones(33, np.float32), G.Q8_0)})


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_pth_equals_jax(tmp_path, wrapped):
    """bf16, fp16, fp32 and int tensors (floats widened to fp32, ints kept),
    a non-tensor entry dropped, a ``state_dict`` wrapper unwrapped."""
    g = torch.Generator().manual_seed(0)
    state = {"a": torch.randn(4, 3, generator=g).bfloat16(), "b": torch.randn(5, generator=g).half(),
             "c": torch.randn(2, 2, generator=g), "d": torch.arange(6, dtype=torch.int64), "step": 3}
    path = str(tmp_path / "m.pth")
    torch.save({"state_dict": state, "epoch": 1} if wrapped else state, path)
    ours, ref = checkpoint.load_pth(path), jweights.load_pth(path)
    assert sorted(ours) == sorted(ref) == ["a", "b", "c", "d"]
    for k in ours:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    for k, v in checkpoint.load_state_dict_any(path).items():
        np.testing.assert_array_equal(v, ref[k])


# --------------------------------------------------------------------------- #
# Tiny checkpoints: a DiT as GGUF (F32, F16, Q8_0), the VAE as .pth and GGUF
# --------------------------------------------------------------------------- #


def _cfg():
    vc = jconfig.vae_tiny()
    dc = dataclasses.replace(jconfig.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    return jconfig.PipelineConfig(dit=dc, vae=vc, resolution=32, batch_size=5, compute_dtype="float32")


def _port_cfg():
    vc = config.vae_tiny()
    dc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    cfg = config.PipelineConfig(dit=dc, vae=vc, resolution=32, batch_size=5, compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_cfg())
    return cfg


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves])


def _gguf_types(state):
    """Q8_0 for the block linears, F16 for the other matrices, F32 for the
    rest: a file with all three types."""
    return {k: (v, G.Q8_0 if k.startswith("blocks.") and v.ndim == 2 else G.F16 if v.ndim >= 2 else G.F32)
            for k, v in state.items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf_models")
    cfg = _cfg()
    dit_p = _perturbed(jnadit.init_params(cfg.dit, jax.random.PRNGKey(0)), 1)
    vae_p = _perturbed(init_vae_params(cfg.vae, jax.random.PRNGKey(1)), 2)
    dit_sd = {k: np.ascontiguousarray(v) for k, v in
              jweights.export_state_dict(dit_p, jweights.dit_key_map(cfg.dit)).items()}
    vae_sd = {k: np.ascontiguousarray(v) for k, v in
              jweights.export_state_dict(vae_p, jweights.vae_key_map(cfg.vae)).items()}
    G.write_gguf(str(d / "tiny_dit.gguf"), _gguf_types(dit_sd))
    G.write_gguf(str(d / "tiny_vae.gguf"), {k: (v, G.F32) for k, v in vae_sd.items()})
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in vae_sd.items()}}, str(d / "tiny_vae.pth"))
    torch.save({k: torch.from_numpy(v) for k, v in dit_sd.items()}, str(d / "tiny_dit.pth"))
    from safetensors.numpy import save_file

    save_file(dit_sd, str(d / "tiny_dit.safetensors"))
    save_file(vae_sd, str(d / "tiny_vae.safetensors"))
    types = {G.read_gguf(str(d / "tiny_dit.gguf")).tensors[k].ggml_type for k in dit_sd}
    assert types == {G.F32, G.F16, G.Q8_0}
    return d


@pytest.fixture
def min_size(monkeypatch):
    monkeypatch.setattr(jquant, "_QUANT_MIN_SIZE", MIN_SIZE)
    monkeypatch.setattr(quant, "_QUANT_MIN_SIZE", MIN_SIZE)


def _dit_inputs(cfg):
    rs = np.random.RandomState(5)
    thw, txt_len, B = (2, 6, 8), 3, 1
    vid = (rs.randn(B, thw[0], thw[1] * 2, thw[2] * 2, cfg.vid_in_channels) * 0.4).astype(np.float32)
    txt = (rs.randn(B, txt_len, cfg.txt_in_dim) * 0.4).astype(np.float32)
    return vid, txt, np.full((B,), 700.0, np.float32), thw, txt_len


@pytest.mark.parametrize("dit_file,quantize", [("tiny_dit.gguf", None), ("tiny_dit.safetensors", "int8"),
                                               ("tiny_dit.pth", "int8"), ("tiny_dit.pth", None)])
def test_load_runner_dit_forward_equals_jax(files, min_size, dit_file, quantize):
    """load_runner's DiT against JAX's load_dit_params (+ quantize_dit_params
    for int8 and for every .gguf) + nadit_forward on the same file."""
    cfg = _cfg()
    runner = loader.load_runner(dit_file, "tiny_vae.safetensors", str(files), _port_cfg(), device="cpu",
                                quantize=quantize)
    assert runner.dit.quantize == ("int8" if quantize or dit_file.endswith(".gguf") else None)
    t_dit = jax.eval_shape(lambda k: jnadit.init_params(cfg.dit, k, jnp.float32), jax.random.PRNGKey(0))
    params = jweights.load_dit_params(str(files / dit_file), cfg.dit, t_dit, np.float32)
    if runner.dit.quantize:
        params = jquant.quantize_dit_params(params)
    vid, txt, t, thw, txt_len = _dit_inputs(cfg.dit)
    ref = np.asarray(jnadit.nadit_forward(jax.tree.map(jnp.asarray, params), cfg.dit, jnp.asarray(vid),
                                          jnp.asarray(txt), jnp.asarray(t), jnadit.build_attn_plans(cfg.dit, thw, txt_len)))
    pc = runner.cfg.dit
    dplans = nadit.device_plans(nadit.build_attn_plans(pc, thw, txt_len), pc.head_dim, "cpu")
    with torch.inference_mode():
        got = runner.dit(torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t), dplans).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("vae_file", ["tiny_vae.gguf", "tiny_vae.pth"])
def test_load_runner_reads_a_gguf_or_pth_vae_dense(files, vae_file):
    """A .gguf or .pth VAE is dequantized and kept in the compute dtype:
    the same weights as the safetensors copy."""
    a = loader.load_runner("tiny_dit.safetensors", vae_file, str(files), _port_cfg(), device="cpu").vae
    b = loader.load_runner("tiny_dit.safetensors", "tiny_vae.safetensors", str(files), _port_cfg(), device="cpu").vae
    for (name, x), (_, y) in zip(a.named_buffers(), b.named_buffers()):
        assert x.dtype == y.dtype == torch.float32 and torch.equal(x, y), name


@pytest.mark.parametrize("variant", ["3b", "7b", "tiny"])
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("gib", [16, 24, 80])
def test_auto_quantize_equals_jax(variant, quantize, gib):
    dit = {"3b": config.dit_3b, "7b": config.dit_7b, "tiny": config.dit_tiny}[variant]()
    jdit = {"3b": jconfig.dit_3b, "7b": jconfig.dit_7b, "tiny": jconfig.dit_tiny}[variant]()
    assert loader.auto_quantize(dit, quantize, gib << 30) == jloader.auto_quantize(jdit, quantize, gib << 30)


@pytest.mark.parametrize("dit_model", ["seedvr2_ema_3b_fp16.safetensors", "seedvr2_ema_7b_fp16.safetensors",
                                       "seedvr2_ema_7b-Q4_K_M.gguf", "seedvr2_ema_3b-Q8_0.gguf", None])
@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("gib", [16, 80])
def test_auto_mesh_weight_bytes_equal_estimate_dit(monkeypatch, dit_model, quantize, gib):
    """The "auto" mesh's weight bytes (parallel/mesh.py:build_mesh on two
    ranks) are inference_cli.py:_estimate_dit's for the same flags and
    device memory."""
    from seedvr2_tpu.pipeline import phases as jph

    monkeypatch.setattr(jph, "_hbm_bytes", lambda: gib << 30)
    monkeypatch.setattr(phases, "_hbm_bytes", lambda device: gib << 30)
    heads, want = inference_cli._estimate_dit(argparse.Namespace(dit_model=dit_model, quantize=quantize))
    seen = {}
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(mesh, "auto_mesh", lambda **kw: seen.update(kw))
    args = cli.parse_arguments(["x.mp4", "--quantize", quantize] + (["--dit_model", dit_model] if dit_model else []))
    mesh.build_mesh("auto", 5, cli._configs(cli._dit_name(args))[0], device="cpu",
                    quantize=None if args.quantize == "none" else args.quantize, dit_model=cli._dit_name(args))
    assert (seen["heads"], seen["model_bytes"], seen["hbm_bytes"]) == (heads, want, gib << 30)


def _jax_noise(cfg, frames):
    """The JAX step's base noise for one 5-frame batch (runner.py)."""
    from seedvr2_tpu.ops.resize import side_resize_dims

    h, w = side_resize_dims(frames.shape[1], frames.shape[2], cfg.resolution, cfg.max_resolution)
    per = (2, -(-h // 16) * 2, -(-w // 16) * 2, cfg.vae.latent_channels)
    k1, _ = jax.random.split(batch_key(cfg.seed, "dit"))
    return np.array(jax.random.normal(k1, per, np.float32))


@pytest.mark.parametrize("dit_file,flags", [("tiny_dit.safetensors", ("--quantize", "int8")),
                                            ("tiny_dit.gguf", ()), ("tiny_dit.pth", ("--quantize", "int8"))])
def test_cli_int8_and_gguf_equal_inference_cli(files, min_size, monkeypatch, tmp_path, dit_file, flags):
    """The runners that the two CLIs build for ``--quantize int8`` or a
    .gguf ``--dit_model`` (both at fp32, 16-bit codes) upscale 5 frames
    alike (JAX's DiT noise handed to the port), and the port's CLI writes
    what phases.generate gives on its runner."""
    import functools

    from seedvr2_tpu_torch.io import frameops, video

    monkeypatch.setattr(jconfig, "PipelineConfig", functools.partial(jconfig.PipelineConfig, compute_dtype="float32"))
    build_config = cli.build_config
    monkeypatch.setattr(cli, "build_config", lambda args: build_config(args).replace(compute_dtype="float32"))
    argv = ["--dit_model", dit_file, "--vae_model", "tiny_vae.safetensors", "--model_dir", str(files),
            "--resolution", "32", "--output_bits", "16", *flags]
    frames = np.random.RandomState(3).rand(5, 24, 20, 3).astype(np.float32)
    jrunner, jcfg, jdebug = inference_cli.build_runner(inference_cli.parse_arguments(["x.mp4", *argv]))
    ref = jphases.generate(jrunner, frames, jcfg, jdebug)
    runner, cfg, _ = cli.build_runner(cli.parse_arguments(["x.mp4", *argv, "--cuda_device", "cpu"]))
    assert runner.dit.quantize == "int8" and cfg.compute_dtype == "float32"
    got = phases.generate(runner, frames, cfg, noise=torch.from_numpy(_jax_noise(cfg, frames)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    video.write_image(str(tmp_path / "in.png"), frames[0])
    assert cli.main([str(tmp_path / "in.png"), "--output", str(tmp_path / "out.png"), *argv,
                     "--cuda_device", "cpu"]) == 0
    want = phases.generate(runner.with_config(cfg), video.read_image(str(tmp_path / "in.png"))[None], packed=True)
    np.testing.assert_array_equal(frameops.to_u8(video.read_image(str(tmp_path / "out.png"))), frameops.to_u8(want[0]))
