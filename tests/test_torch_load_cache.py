"""The load path's cold start: the streamed conversion of io/weights.py and
the weights cache of io/native_ckpt.py, against the JAX package.

- The cache's semantics against seedvr2_tpu/io/native_ckpt.py:load_or_convert
  on the same sequence of loads: two loads convert once, a touched source
  converts again; then the port's own cases: another dtype or
  quantize in a file of its own, another config's file replaced, an
  unreadable cache converted again, an unwritable directory or a failed
  write loading without it, each with its log line; a killed run's
  temporary removed by the next conversion.
- The streamed loader (dit_from_checkpoint / vae_from_checkpoint) against
  the JAX loader's tree (seedvr2_tpu/io/weights.py load_dit_params /
  load_vae_params, then quantize_dit_params for int8; every .gguf DiT is
  int8) through dit_from_jax / vae_from_jax: safetensors (fp16), a Q8_0
  and a Q4_K GGUF and .pth, quantize None and "int8", at tensor 1 and at
  both ranks of tensor 2. Every tensor equal (models/params.py:
  loaded_tensors: buffers, K1's layout, K2's folds), bf16.
- The warm (cached) load against the cold one: every tensor equal, and one
  tiny phases.generate batch 0 codes apart.

The tiny configs' block linears are below the 65,536-element threshold, so
the int8 cases set both packages' _QUANT_MIN_SIZE to 1024.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu import config as jconfig
from seedvr2_tpu.io import native_ckpt as jnative
from seedvr2_tpu.io import weights as jweights
from seedvr2_tpu.models.dit import nadit as jnadit
from seedvr2_tpu.models.vae.model import init_vae_params
from seedvr2_tpu.ops import quant as jquant
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io import gguf as G
from seedvr2_tpu_torch.io import native_ckpt, weights
from seedvr2_tpu_torch.io.checkpoint import CheckpointReader, flatten_tree, load_state_dict_any
from seedvr2_tpu_torch.models.params import loaded_tensors
from seedvr2_tpu_torch.ops import quant
from seedvr2_tpu_torch.parallel.sharding import shard_flat
from seedvr2_tpu_torch.pipeline import loader, phases
from seedvr2_tpu_torch.utils.debug import Debug

MIN_SIZE = 1024
DTYPE = torch.bfloat16


# --------------------------------------------------------------------------- #
# The cache's semantics
# --------------------------------------------------------------------------- #


class _Log(Debug):
    """Keeps the forced lines; ``what`` names each cache line's case."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def log(self, msg, category="info", force=False, indent_level=0):
        if force:
            self.lines.append(msg)

    def what(self):
        out = []
        for ln in self.lines:
            rest = ln[len("Weights cache: "):] if ln.startswith("Weights cache: ") else None
            if rest is not None:
                out.append(next((c for c in ("converted", "read", "cannot write") if rest.startswith(c)), None)
                           or ("failed" if rest.startswith("writing") else
                               "stale" if " is stale (" in rest else "unreadable" if " is unreadable (" in rest
                               else rest))
        return out


def _port_load(src, calls, log, dtype=torch.float32, quantize=None, source_key="w"):
    """A one-leaf load of ``src`` through the cache in ``<its dir>/torch_cache``."""
    layout = [("w", dtype, (4,))]
    settings = native_ckpt.settings_for("dit", {"w": (source_key, "none")}, dtype, quantize, layout)

    def convert(sink):
        calls.append(1)
        t = torch.arange(4, dtype=dtype)
        sink("w", t)
        return t

    return native_ckpt.load_or_convert(str(src), layout, settings, convert, lambda get: get("w"), log)


def _source(d):
    d.mkdir(exist_ok=True)
    (d / "model.safetensors").write_bytes(b"fake")
    return d / "model.safetensors"


def test_cache_converts_once_and_again_after_a_touch_as_jax(tmp_path):
    """tests/test_native_ckpt.py's sequence on both packages: load, load,
    touch the source, load; the conversions counted after each."""
    src = _source(tmp_path)
    port_calls, jax_calls, counts, log = [], [], [], _Log()

    def jax_convert(path):
        jax_calls.append(1)
        return {"w": np.arange(4, dtype=np.float32)}

    for step in ("load", "load", "touch", "load"):
        if step == "touch":
            st = os.stat(src)
            os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
            continue
        got = _port_load(src, port_calls, log)
        ref = jnative.load_or_convert(str(src), jax_convert, cache_dir=str(tmp_path / "cache.orbax"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref["w"]))
        counts.append((len(port_calls), len(jax_calls)))
    assert counts == [(1, 1), (1, 1), (2, 2)]
    assert log.what() == ["converted", "read", "stale", "converted"]
    assert "is stale (source_mtime_ns differ)" in log.lines[2]


def test_cache_other_settings_unreadable_and_unwritable(tmp_path, monkeypatch):
    src = _source(tmp_path)
    cache = tmp_path / "torch_cache"
    calls, log = [], _Log()
    _port_load(src, calls, log)
    # another dtype or quantize: a file of its own, converted once, then read
    _port_load(src, calls, log, dtype=torch.bfloat16)
    _port_load(src, calls, log, dtype=torch.bfloat16, quantize="int8")
    assert _port_load(src, calls, log, dtype=torch.bfloat16).dtype == torch.bfloat16
    assert torch.equal(_port_load(src, calls, log), torch.arange(4.0)) and len(calls) == 3
    assert sorted(os.listdir(cache)) == ["model.safetensors.bfloat16.int8.safetensors",
                                         "model.safetensors.bfloat16.safetensors",
                                         "model.safetensors.float32.safetensors"]
    # another config under the same settings (a changed key map): converted again and the file replaced
    _port_load(src, calls, log, source_key="v")
    assert len(calls) == 4 and "is stale (config differ)" in log.lines[-2]
    _port_load(src, calls, log, source_key="v")
    assert len(calls) == 4
    # unreadable: a truncated file is converted again and replaced
    f32 = cache / "model.safetensors.float32.safetensors"
    f32.write_bytes(f32.read_bytes()[:40])
    assert torch.equal(_port_load(src, calls, log), torch.arange(4.0))
    _port_load(src, calls, log)
    assert len(calls) == 5
    # unwritable: the cache's directory is a file; the load goes on without the cache
    blocked = _source(tmp_path / "blocked")
    (tmp_path / "blocked" / "torch_cache").write_bytes(b"")
    assert torch.equal(_port_load(blocked, calls, log), torch.arange(4.0))
    assert len(calls) == 6

    # a write that fails half-way (a full disk): the load goes on, no file and no temporary is left
    def full(self, name, t):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(native_ckpt.CacheWriter, "add", full)
    assert torch.equal(_port_load(_source(tmp_path / "d"), calls, log), torch.arange(4.0))
    assert len(calls) == 7 and os.listdir(tmp_path / "d" / "torch_cache") == []
    assert log.what() == ["converted", "converted", "converted", "read", "read", "stale", "converted", "read",
                          "unreadable", "converted", "read", "cannot write", "failed"]


def test_a_conversion_removes_the_temporaries_of_killed_runs(tmp_path):
    """A killed conversion leaves ``<cache>.<pid>.<hex>.tmp``; the next
    conversion of that file removes it once its pid is gone, and leaves a
    live writer's temporary and other files' alone."""
    src = _source(tmp_path)
    cache = tmp_path / "torch_cache"
    cache.mkdir()
    dead = subprocess.Popen([sys.executable, "-c", ""])
    dead.wait()
    name = "model.safetensors.float32.safetensors"
    killed = cache / f"{name}.{dead.pid}.0123abcd.tmp"
    running = cache / f"{name}.{os.getpid()}.89abcdef.tmp"
    other = cache / f"other.safetensors.float32.safetensors.{dead.pid}.0123abcd.tmp"
    for f in (killed, running, other):
        f.write_bytes(b"partial")
    calls = []
    _port_load(src, calls, _Log())
    assert len(calls) == 1
    assert sorted(os.listdir(cache)) == sorted([name, running.name, other.name])


# --------------------------------------------------------------------------- #
# Tiny checkpoints: the DiT as fp16 safetensors, Q8_0 and Q4_K GGUF and .pth
# --------------------------------------------------------------------------- #


def _cfg():
    vc = jconfig.vae_tiny()
    dc = dataclasses.replace(jconfig.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    return jconfig.PipelineConfig(dit=dc, vae=vc, resolution=32, batch_size=5, compute_dtype="bfloat16")


def _port_cfg():
    vc = config.vae_tiny()
    dc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    cfg = config.PipelineConfig(dit=dc, vae=vc, resolution=32, batch_size=5, compute_dtype="bfloat16")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_cfg())
    return cfg


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves])


def _q4_k_blocks(n, seed):
    """Random Q4_K blocks for n values, with finite f16 super-block scales."""
    rs = np.random.RandomState(seed)
    blocks = rs.randint(0, 256, (n // 256, 144)).astype(np.uint8)
    blocks[:, 0:2] = np.frombuffer(np.float16(0.02).tobytes(), np.uint8)
    blocks[:, 2:4] = np.frombuffer(np.float16(0.01).tobytes(), np.uint8)
    return blocks.tobytes()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("load_cache_models")
    cfg = _cfg()
    dit_sd = {k: np.ascontiguousarray(v) for k, v in jweights.export_state_dict(
        _perturbed(jnadit.init_params(cfg.dit, jax.random.PRNGKey(0)), 1), jweights.dit_key_map(cfg.dit)).items()}
    vae_sd = {k: np.ascontiguousarray(v) for k, v in jweights.export_state_dict(
        _perturbed(init_vae_params(cfg.vae, jax.random.PRNGKey(1)), 2), jweights.vae_key_map(cfg.vae)).items()}
    save_file({k: v.astype(np.float16) for k, v in dit_sd.items()}, str(d / "tiny_dit.safetensors"))
    save_file(vae_sd, str(d / "tiny_vae.safetensors"))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in dit_sd.items()}}, str(d / "tiny_dit.pth"))
    torch.save({k: torch.from_numpy(v).half() for k, v in vae_sd.items()}, str(d / "tiny_vae.pth"))
    G.write_gguf(str(d / "tiny_dit_q8.gguf"), {k: (v, G.Q8_0 if k.startswith("blocks.") and v.ndim == 2 else
                                                  G.F16 if v.ndim >= 2 else G.F32) for k, v in dit_sd.items()})
    G.write_gguf(str(d / "tiny_vae.gguf"), {k: (v, G.F16 if v.ndim >= 2 else G.F32) for k, v in vae_sd.items()})
    # a K-quant DiT: the block matrices as raw Q4_K blocks (the port's writer has no K-quant encoder)
    k_quant = {k for k, v in dit_sd.items() if k.startswith("blocks.") and v.ndim == 2 and v.size % 256 == 0}
    assert len(k_quant) > 10
    real_encode = G._encode
    try:
        G._encode = lambda arr, t: _q4_k_blocks(arr.size, arr.size) if t == G.Q4_K else real_encode(arr, t)
        G.write_gguf(str(d / "tiny_dit_q4k.gguf"), {k: (v, G.Q4_K if k in k_quant else G.F32)
                                                    for k, v in dit_sd.items()})
    finally:
        G._encode = real_encode
    return d


@pytest.fixture
def min_size(monkeypatch):
    monkeypatch.setattr(jquant, "_QUANT_MIN_SIZE", MIN_SIZE)
    monkeypatch.setattr(quant, "_QUANT_MIN_SIZE", MIN_SIZE)


def _jax_dit_flat(path, quantize):
    """The JAX loader's DiT tree (fp32; quantize_dit_params for int8 and
    for every .gguf, as its load_runner), flattened."""
    cfg = _cfg()
    t_dit = jax.eval_shape(lambda k: jnadit.init_params(cfg.dit, k, jnp.float32), jax.random.PRNGKey(0))
    params = jweights.load_dit_params(str(path), cfg.dit, t_dit, np.float32)
    if quantize == "int8" or str(path).endswith(".gguf"):
        params = jquant.quantize_dit_params(params)
    return {k: np.asarray(v) for k, v in flatten_tree(params).items()}


def _assert_equal(got, ref):
    a, b = loaded_tensors(got), loaded_tensors(ref)
    assert a.keys() == b.keys()
    bad = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    assert not bad, bad[:5]


@pytest.mark.parametrize("dit_file", ["tiny_dit.safetensors", "tiny_dit_q8.gguf", "tiny_dit_q4k.gguf",
                                      "tiny_dit.pth"])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_streamed_dit_equals_the_jax_loaders_tree(files, min_size, dit_file, quantize):
    """At tensor 1 and at both ranks of tensor 2 (the JAX tree split with
    parallel/sharding.py:shard_flat, as GSPMD splits it)."""
    q = "int8" if quantize or dit_file.endswith(".gguf") else None
    flat = _jax_dit_flat(files / dit_file, quantize)
    pc = _port_cfg()
    for size, rank in ((1, 0), (2, 0), (2, 1)):
        got = weights.dit_from_checkpoint(str(files / dit_file), pc.dit, "cpu", DTYPE, rank, size, q)
        ref = weights.dit_from_flat(shard_flat(flat, pc.dit, rank, size) if size > 1 else flat, pc.dit, "cpu",
                                    DTYPE, tensor=size)
        assert got.quantize == q and got.tensor == size
        _assert_equal(got, ref)


@pytest.mark.parametrize("vae_file", ["tiny_vae.safetensors", "tiny_vae.gguf", "tiny_vae.pth"])
def test_streamed_vae_equals_the_jax_loaders_tree(files, vae_file):
    cfg = _cfg()
    t_vae = jax.eval_shape(lambda k: init_vae_params(cfg.vae, k, jnp.float32), jax.random.PRNGKey(0))
    params = jweights.load_vae_params(str(files / vae_file), cfg.vae, t_vae, np.float32)
    got = weights.vae_from_checkpoint(str(files / vae_file), _port_cfg().vae, "cpu", DTYPE)
    _assert_equal(got, weights.vae_from_jax(params, _port_cfg().vae, "cpu", DTYPE))


def test_reader_gives_the_whole_file_readers_arrays(files):
    """One tensor at a time, the same arrays as load_state_dict_any; a
    missing key raises before any leaf is read."""
    for name in ("tiny_dit.safetensors", "tiny_dit_q4k.gguf", "tiny_dit.pth", "tiny_vae.pth"):
        whole = load_state_dict_any(str(files / name))
        with CheckpointReader(str(files / name)) as reader:
            assert sorted(reader.keys()) == sorted(whole)
            for k, v in reader:
                assert v.dtype == whole[k].dtype
                np.testing.assert_array_equal(v, whole[k])
    key_map = dict(weights.dit_key_map(_port_cfg().dit), extra=("not.in.the.file", "none"))
    with pytest.raises(KeyError, match="missing 1 keys"):
        weights.checkpoint_leaves(str(files / "tiny_dit.safetensors"), key_map)


@pytest.mark.parametrize("dit_file,quantize,size,rank", [
    ("tiny_dit.safetensors", None, 1, 0), ("tiny_dit.safetensors", "int8", 2, 1), ("tiny_dit_q8.gguf", None, 2, 0),
    ("tiny_dit.pth", None, 1, 0)])
def test_warm_load_equals_the_cold_one(files, min_size, tmp_path, dit_file, quantize, size, rank):
    """load_cached twice on a fresh copy of the files: the first converts
    and writes the cache (whole, every leaf in its load type), the second
    reads it; the DiT (this rank's part) and the VAE bit-equal, and equal
    to the uncached streamed load."""
    for name in (dit_file, "tiny_vae.safetensors"):
        (tmp_path / name).write_bytes((files / name).read_bytes())
    q = "int8" if quantize or dit_file.endswith(".gguf") else None
    pc, loads = _port_cfg(), []
    for want in ("converted", "read"):
        log = _Log()
        dit = weights.load_cached("dit", str(tmp_path / dit_file), pc.dit, "cpu", DTYPE, rank, size, q, log)
        vae = weights.load_cached("vae", str(tmp_path / "tiny_vae.safetensors"), pc.vae, "cpu", DTYPE, debug=log)
        assert log.what() == [want, want], log.lines
        loads.append((dit, vae))
    for a, b in zip(*loads):
        _assert_equal(a, b)
    _assert_equal(loads[0][0], weights.dit_from_checkpoint(str(files / dit_file), pc.dit, "cpu", DTYPE, rank, size, q))
    from safetensors import safe_open

    cache = native_ckpt.cache_path(str(tmp_path / dit_file), "bfloat16" + (".int8" if q else ""))
    with safe_open(cache, framework="pt") as f:
        types = {f.get_tensor(k).dtype for k in f.keys()}
        assert f.metadata()["quantize"] == (q or "none") and f.metadata()["dtype"] == "bfloat16"
    assert types == ({torch.bfloat16, torch.int8, torch.float32} if q else {torch.bfloat16})


def test_load_runner_warm_batch_equals_the_cold_one(files, tmp_path):
    """Two load_runner calls on the same files (the second from the
    cache): one tiny phases.generate batch from each, 0 codes apart."""
    for name in ("tiny_dit.safetensors", "tiny_vae.safetensors"):
        (tmp_path / name).write_bytes((files / name).read_bytes())
    frames = np.random.RandomState(3).rand(5, 20, 24, 3).astype(np.float32)
    outs = []
    for _ in range(2):
        runner = loader.load_runner("tiny_dit.safetensors", "tiny_vae.safetensors", str(tmp_path), _port_cfg(),
                                    device="cpu")
        outs.append(phases.generate(runner, frames, packed=True))
    assert sorted(os.listdir(tmp_path / "torch_cache")) == ["tiny_dit.safetensors.bfloat16.safetensors",
                                                             "tiny_vae.safetensors.bfloat16.safetensors"]
    assert outs[0].shape[0] == 5 and np.abs(outs[0].astype(np.int64) - outs[1].astype(np.int64)).max() == 0
