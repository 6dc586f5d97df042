"""The released model files: their repositories and SHA-256 hashes, which
model a checkpoint file holds, the hash check with its mtime-keyed cache,
the resumable download and the search of model directories (the port's
copy of seedvr2_tpu/io/registry.py; same table, same URLs, same files).

``download_model`` fetches a released file from its Hugging Face
repository (resumed through a ``.part`` file and an HTTP ``Range``
header, three tries) and checks its hash; pipeline/loader.py calls it for
a file that is missing. Pure Python (urllib, hashlib): nothing happens at
import time.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class ModelInfo:
    repo: str = "numz/SeedVR2_comfyUI"
    category: str = "dit"
    precision: str = "fp16"
    size: str = "3B"
    variant: Optional[str] = None
    sha256: Optional[str] = None


MODEL_REGISTRY: Dict[str, ModelInfo] = {
    "seedvr2_ema_3b-Q4_K_M.gguf": ModelInfo(
        repo="AInVFX/SeedVR2_comfyUI", size="3B", precision="Q4_K_M",
        sha256="e665e3909de1a8c88a69c609bca9d43ff5a134647face2ce4497640cc3597f0e"),
    "seedvr2_ema_3b-Q8_0.gguf": ModelInfo(
        repo="AInVFX/SeedVR2_comfyUI", size="3B", precision="Q8_0",
        sha256="be0d60083a2051a265eb4b77f28edf494e6db67ffc250216f32b72292e5cbd96"),
    "seedvr2_ema_3b_fp8_e4m3fn.safetensors": ModelInfo(
        size="3B", precision="fp8_e4m3fn",
        sha256="3bf1e43ebedd570e7e7a0b1b60d6a02e105978f505c8128a241cde99a8240cff"),
    "seedvr2_ema_3b_fp16.safetensors": ModelInfo(
        size="3B", precision="fp16",
        sha256="2fd0e03a3dad24e07086750360727ca437de4ecd456f769856e960ae93e2b304"),
    "seedvr2_ema_7b-Q4_K_M.gguf": ModelInfo(
        repo="AInVFX/SeedVR2_comfyUI", size="7B", precision="Q4_K_M",
        sha256="db9cb2ad90ebd40d2e8c29da2b3fc6fd03ba87cd58cbadceccca13ad27162789"),
    "seedvr2_ema_7b_fp8_e4m3fn_mixed_block35_fp16.safetensors": ModelInfo(
        repo="AInVFX/SeedVR2_comfyUI", size="7B", precision="fp8_e4m3fn_mixed_block35_fp16",
        sha256="3d68b5ec0b295ae28092e355c8cad870edd00b817b26587d0cb8f9dd2df19bb2"),
    "seedvr2_ema_7b_fp16.safetensors": ModelInfo(
        size="7B", precision="fp16",
        sha256="7b8241aa957606ab6cfb66edabc96d43234f9819c5392b44d2492d9f0b0bbe4a"),
    "seedvr2_ema_7b_sharp-Q4_K_M.gguf": ModelInfo(
        repo="AInVFX/SeedVR2_comfyUI", size="7B", precision="Q4_K_M", variant="sharp",
        sha256="7aed800ac4eb8e0d18569a954c0ff35f5a1caa3ed5d920e66cc31405f75b6e69"),
    "seedvr2_ema_7b_sharp_fp8_e4m3fn_mixed_block35_fp16.safetensors": ModelInfo(
        repo="AInVFX/SeedVR2_comfyUI", size="7B", precision="fp8_e4m3fn_mixed_block35_fp16", variant="sharp",
        sha256="0d2c5b8be0fda94351149c5115da26aef4f4932a7a2a928c6f184dda9186e0be"),
    "seedvr2_ema_7b_sharp_fp16.safetensors": ModelInfo(
        size="7B", precision="fp16", variant="sharp",
        sha256="20a93e01ff24beaeebc5de4e4e5be924359606c356c9c51509fba245bd2d77dd"),
    "ema_vae_fp16.safetensors": ModelInfo(
        category="vae", precision="fp16",
        sha256="20678548f420d98d26f11442d3528f8b8c94e57ee046ef93dbb7633da8612ca1"),
}

DEFAULT_DIT = "seedvr2_ema_3b_fp16.safetensors"  # the CLI's and the DiT node's default
DEFAULT_VAE = "ema_vae_fp16.safetensors"


def available_models(category: str) -> List[str]:
    """The table's file names of one category ("dit" or "vae"), in order."""
    return [k for k, v in MODEL_REGISTRY.items() if v.category == category]


def model_variant(model_name: str) -> str:
    """'7b' iff '7b' appears in the name, else '3b'. 'tiny' selects the
    smoke-test configuration (CI-sized models, not a released variant)."""
    low = model_name.lower()
    if "tiny" in low:
        return "tiny"
    return "7b" if "7b" in low else "3b"


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _cache_path(path: str) -> str:
    return path + ".sha256.json"


def verify_model(path: str, expected: Optional[str]) -> bool:
    """Whether ``path`` exists and (with ``expected``) hashes to it. A match
    is remembered in ``<path>.sha256.json`` with the file's mtime, so a file
    that has not changed since is not hashed again."""
    if expected is None:
        return os.path.exists(path)
    if not os.path.exists(path):
        return False
    mtime = os.path.getmtime(path)
    cpath = _cache_path(path)
    if os.path.exists(cpath):
        try:
            with open(cpath) as f:
                c = json.load(f)
            if c.get("mtime") == mtime and c.get("sha256") == expected:
                return True
        except (OSError, ValueError, AttributeError):
            pass  # an unreadable record: hash the file again
    digest = sha256_file(path)
    ok = digest == expected
    if ok:
        _remember(path, mtime, digest)
    return ok


def _remember(path: str, mtime: float, digest: str) -> None:
    """Record that ``path`` at ``mtime`` hashes to ``digest``."""
    with open(_cache_path(path), "w") as f:
        json.dump({"mtime": mtime, "sha256": digest}, f)


def download_model(model_name: str, model_dir: str, retries: int = 3, progress: bool = True) -> str:
    """``model_dir/model_name``, fetched from its Hugging Face repository
    unless it is there and its hash checks. A partial download is kept in
    ``.part`` and resumed with a ``Range`` request; each of ``retries``
    tries that fails waits 2 s times its number before the next, and the
    last one's error is raised (an ``IOError`` when the hash does not
    match). ``progress`` is kept for the JAX package's signature.

    The hash is checked on ``.part`` before it takes the final name, and a
    ``.part`` that fails it is deleted, so the next try starts from zero and
    a failed download leaves nothing at ``model_dir/model_name``. The JAX
    package renames first and checks after, so a file that never matched
    stays there and its loader, which only checks that the file exists,
    reads it."""
    os.makedirs(model_dir, exist_ok=True)
    info = MODEL_REGISTRY.get(model_name, ModelInfo())
    path = os.path.join(model_dir, model_name)
    if verify_model(path, info.sha256):
        return path
    url = f"https://huggingface.co/{info.repo}/resolve/main/{model_name}"
    tmp = path + ".part"
    for attempt in range(retries):
        try:
            headers = {}
            mode = "wb"
            if os.path.exists(tmp):
                headers["Range"] = f"bytes={os.path.getsize(tmp)}-"
                mode = "ab"
            req = urllib.request.Request(url, headers=headers)
            with urllib.request.urlopen(req) as r, open(tmp, mode) as f:
                while True:
                    buf = r.read(1 << 20)
                    if not buf:
                        break
                    f.write(buf)
            digest = sha256_file(tmp) if info.sha256 is not None else None
            if digest != info.sha256:
                os.remove(tmp)
                raise IOError(f"SHA256 mismatch for {model_name}")
            os.replace(tmp, path)
            if digest is not None:
                _remember(path, os.path.getmtime(path), digest)
            return path
        except Exception:  # a network, disk or hash failure: the next try, or the last one's error
            if attempt == retries - 1:
                raise
            time.sleep(2.0 * (attempt + 1))
    return path


def find_model_path(model_name: str, search_dirs: List[str]) -> Optional[str]:
    """The first of ``search_dirs`` that holds ``model_name``: the exact
    name first, else a case-insensitive match; None if none does."""
    target = model_name.lower()
    for d in search_dirs:
        if not os.path.isdir(d):
            continue
        exact = os.path.join(d, model_name)
        if os.path.exists(exact):
            return exact
        for f in os.listdir(d):
            if f.lower() == target:
                return os.path.join(d, f)
    return None


def discovered_models(search_dirs: List[str], category: str = "dit") -> List[str]:
    """The table's models of ``category``, then every other checkpoint file
    (.safetensors, .gguf, .pth) found in ``search_dirs``, each directory's
    in name order."""
    names = list(available_models(category))
    exts = (".safetensors", ".gguf", ".pth")
    for d in search_dirs:
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if f.endswith(exts) and f not in names:
                names.append(f)
    return names
