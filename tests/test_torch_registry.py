"""The port's model registry (seedvr2_tpu_torch/io/registry.py) against the
JAX package's seedvr2_tpu/io/registry.py: the table with its repositories
and hashes, the hash check and its .sha256.json record, the directory
search, and the resumable download, both downloaders run under one fake
hub (tests/fake_hub.py: urllib.request.urlopen replaced, time.sleep
recorded), so that no request leaves the machine. Then load_runner
fetching a missing file through the same fake.
"""

import dataclasses
import hashlib
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from fake_hub import FakeHub, hub_url
from seedvr2_tpu.io import registry as jregistry
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io import registry
from seedvr2_tpu_torch.io.weights import save_random_checkpoint
from seedvr2_tpu_torch.models.params import loaded_tensors
from seedvr2_tpu_torch.pipeline import loader


def test_table_with_repositories_and_hashes_equals_jax():
    assert list(registry.MODEL_REGISTRY) == list(jregistry.MODEL_REGISTRY)
    for name, info in registry.MODEL_REGISTRY.items():
        assert dataclasses.asdict(info) == dataclasses.asdict(jregistry.MODEL_REGISTRY[name]), name
        assert info.sha256 is not None and len(info.sha256) == 64
    assert dataclasses.asdict(registry.ModelInfo()) == dataclasses.asdict(jregistry.ModelInfo())


def test_sha256_file_and_verify_model_equal_jax(tmp_path):
    """The digest, the check with and without an expected hash, and the
    record each package writes (the other package's record is read as its
    own), for a file hashed in several 1 MiB chunks."""
    data = np.random.RandomState(0).bytes((3 << 20) + 17)
    digest = hashlib.sha256(data).hexdigest()
    records = []
    for mod, name in ((registry, "port.bin"), (jregistry, "jax.bin")):
        p = tmp_path / name
        p.write_bytes(data)
        os.utime(p, (1.7e9, 1.7e9))
        assert mod.sha256_file(str(p)) == digest
        assert mod.verify_model(str(p), None) and not mod.verify_model(str(tmp_path / "no.bin"), digest)
        assert not mod.verify_model(str(p), "0" * 64) and not os.path.exists(str(p) + ".sha256.json")
        assert mod.verify_model(str(p), digest)
        records.append(json.loads((tmp_path / (name + ".sha256.json")).read_text()))
    assert records[0] == records[1] == {"mtime": 1.7e9, "sha256": digest}
    # a record of the right mtime and hash is trusted without hashing; a stale or broken one is not
    for mod, other in ((registry, "jax.bin"), (jregistry, "port.bin")):
        p = tmp_path / other
        p.write_bytes(b"changed, same mtime")
        os.utime(p, (1.7e9, 1.7e9))
        assert mod.verify_model(str(p), digest)
        os.utime(p, (1.8e9, 1.8e9))
        assert not mod.verify_model(str(p), digest)
        (tmp_path / (other + ".sha256.json")).write_text("[not a record")
        assert not mod.verify_model(str(p), digest)


def test_find_model_path_and_discovered_models_equal_jax(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    for d, names in ((a, ["x.safetensors", "notes.txt"]), (b, ["Model_X.SafeTensors", "z.gguf", "y.pth",
                                                               "seedvr2_ema_3b_fp16.safetensors"])):
        for n in names:
            (d / n).write_bytes(b"w")
    dirs = [str(tmp_path / "missing"), str(a), str(b)]
    for name in ("x.safetensors", "model_x.safetensors", "MODEL_X.SAFETENSORS", "z.gguf", "gone.pth"):
        assert registry.find_model_path(name, dirs) == jregistry.find_model_path(name, dirs), name
    assert registry.find_model_path("model_x.safetensors", dirs) == str(b / "Model_X.SafeTensors")
    for category in ("dit", "vae"):
        got = registry.discovered_models(dirs, category)
        assert got == jregistry.discovered_models(dirs, category)
        assert got[: len(registry.available_models(category))] == registry.available_models(category)
    assert "z.gguf" in registry.discovered_models(dirs) and "notes.txt" not in registry.discovered_models(dirs)


NAME, REPO = "tiny_fetch.safetensors", "someone/tiny"
DATA = np.random.RandomState(1).bytes((2 << 20) + 1000)  # three 1 MiB reads


@pytest.mark.parametrize("case", ["fresh", "cut mid-stream", "part left over", "present", "hash mismatch", "404",
                                  "bad file present"])
def test_download_model_equals_jax(tmp_path, monkeypatch, case):
    """Both downloaders against one fake hub each: the same requests in the
    same order (URL, Range), the same sleeps, the same file and .part
    left behind, the same result or the same exception. One divergence:
    after a hash mismatch on every try the port leaves nothing behind (it
    checks .part before the rename and deletes it), where JAX's tree keeps
    the bad file at its final name. A bad file already at the final name
    is fetched again by both."""
    sha = hashlib.sha256(DATA).hexdigest() if case != "hash mismatch" else "f" * 64
    name = NAME if case != "404" else "not_on_the_hub.safetensors"
    results = []
    for mod in (registry, jregistry):
        monkeypatch.setitem(mod.MODEL_REGISTRY, NAME, mod.ModelInfo(repo=REPO, sha256=sha))
        hub = FakeHub({hub_url(REPO, NAME): DATA}, cut_after=(1 << 20) + 5 if case == "cut mid-stream" else None)
        sleeps = []
        monkeypatch.setattr(urllib.request, "urlopen", hub.urlopen)
        monkeypatch.setattr(time, "sleep", sleeps.append)
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        if case == "part left over":
            (d / (NAME + ".part")).write_bytes(DATA[:777])
        if case == "present":
            (d / NAME).write_bytes(DATA)
        if case == "bad file present":
            (d / NAME).write_bytes(DATA[:1000] + b"not the released bytes")
        try:
            got = mod.download_model(name, str(d))
            outcome = ("ok", os.path.relpath(got, d))
        except (urllib.error.HTTPError, IOError) as e:
            outcome = (type(e).__name__, getattr(e, "code", None), str(e))
        files = {f.name: f.read_bytes() for f in d.iterdir() if not f.name.endswith(".sha256.json")}
        results.append((outcome, hub.requests, sleeps, files))
    if case == "hash mismatch":  # the port's deliberate divergence (ROADMAP queue 3)
        assert results[0][:3] == results[1][:3]
        assert results[0][3] == {} and results[1][3] == {NAME: DATA}
    else:
        assert results[0] == results[1]
    outcome, requests, sleeps, files = results[0]
    if case in ("fresh", "present"):
        assert outcome == ("ok", NAME) and files == {NAME: DATA} and len(requests) == (case == "fresh")
    elif case in ("cut mid-stream", "part left over"):
        start = (1 << 20) + 5 if case == "cut mid-stream" else 777
        assert outcome == ("ok", NAME) and files == {NAME: DATA}
        assert requests[-1] == (hub_url(REPO, NAME), f"bytes={start}-")
        assert sleeps == ([2.0] if case == "cut mid-stream" else [])
    elif case == "hash mismatch":
        assert outcome[0] == "OSError" and "SHA256 mismatch" in outcome[2] and sleeps == [2.0, 4.0]
        assert [r[1] for r in requests] == [None, None, None] and files == {}
    elif case == "bad file present":
        assert outcome == ("ok", NAME) and files == {NAME: DATA} and requests == [(hub_url(REPO, NAME), None)]
    else:
        assert outcome[:2] == ("HTTPError", 404) and sleeps == [2.0, 4.0] and len(requests) == 3 and files == {}


def _tiny_cfg():
    vc = config.vae_tiny()
    dc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    return config.PipelineConfig(dit=dc, vae=vc, resolution=32, compute_dtype="float32")


def test_load_runner_fetches_a_missing_file(tmp_path, monkeypatch):
    """A DiT missing from model_dir is fetched through download_model (its
    hash checked), then loaded like the file itself; download=False
    raises instead, before any request."""
    cfg = _tiny_cfg()
    src = tmp_path / "src"
    src.mkdir()
    save_random_checkpoint(str(src / NAME), "dit", cfg.dit, torch.Generator().manual_seed(0), torch.float32)
    save_random_checkpoint(str(src / "tiny_vae.safetensors"), "vae", cfg.vae, torch.Generator().manual_seed(1),
                           torch.float32)
    data = (src / NAME).read_bytes()
    monkeypatch.setitem(registry.MODEL_REGISTRY, NAME,
                        registry.ModelInfo(repo=REPO, sha256=hashlib.sha256(data).hexdigest()))
    hub = FakeHub({hub_url(REPO, NAME): data})
    monkeypatch.setattr(urllib.request, "urlopen", hub.urlopen)
    models = tmp_path / "models"
    models.mkdir()
    (models / "tiny_vae.safetensors").write_bytes((src / "tiny_vae.safetensors").read_bytes())
    with pytest.raises(FileNotFoundError, match=NAME):
        loader.load_runner(NAME, "tiny_vae.safetensors", str(models), cfg, device="cpu", download=False)
    assert hub.requests == []
    got = loader.load_runner(NAME, "tiny_vae.safetensors", str(models), cfg, device="cpu")
    assert hub.requests == [(hub_url(REPO, NAME), None)] and (models / NAME).read_bytes() == data
    ref = loader.load_runner(NAME, "tiny_vae.safetensors", str(src), cfg, device="cpu")
    a, b = loaded_tensors(got.dit), loaded_tensors(ref.dit)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_load_runner_after_a_hash_mismatch_fetches_again(tmp_path, monkeypatch):
    """A download whose bytes never match the registry's hash raises and
    leaves no file, so the next load_runner fetches the file again (and
    loads what it gets) instead of loading the bad bytes unchecked; the
    weights cache keeps no conversion of them."""
    cfg = _tiny_cfg()
    src = tmp_path / "src"
    src.mkdir()
    save_random_checkpoint(str(src / NAME), "dit", cfg.dit, torch.Generator().manual_seed(0), torch.float32)
    save_random_checkpoint(str(src / "tiny_vae.safetensors"), "vae", cfg.vae, torch.Generator().manual_seed(1),
                           torch.float32)
    data = (src / NAME).read_bytes()
    monkeypatch.setitem(registry.MODEL_REGISTRY, NAME,
                        registry.ModelInfo(repo=REPO, sha256=hashlib.sha256(data).hexdigest()))
    monkeypatch.setattr(time, "sleep", lambda s: None)
    models = tmp_path / "models"
    models.mkdir()
    (models / "tiny_vae.safetensors").write_bytes((src / "tiny_vae.safetensors").read_bytes())
    bad = FakeHub({hub_url(REPO, NAME): data[:-8] + bytes(8)})
    monkeypatch.setattr(urllib.request, "urlopen", bad.urlopen)
    with pytest.raises(OSError, match="SHA256 mismatch"):
        loader.load_runner(NAME, "tiny_vae.safetensors", str(models), cfg, device="cpu")
    assert len(bad.requests) == 3
    assert not (models / NAME).exists() and not (models / (NAME + ".part")).exists()
    cache = models / "torch_cache"
    assert not cache.exists() or not any(NAME in f.name for f in cache.iterdir())
    good = FakeHub({hub_url(REPO, NAME): data})
    monkeypatch.setattr(urllib.request, "urlopen", good.urlopen)
    got = loader.load_runner(NAME, "tiny_vae.safetensors", str(models), cfg, device="cpu")
    assert good.requests == [(hub_url(REPO, NAME), None)] and (models / NAME).read_bytes() == data
    ref = loader.load_runner(NAME, "tiny_vae.safetensors", str(src), cfg, device="cpu")
    a, b = loaded_tensors(got.dit), loaded_tensors(ref.dit)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
