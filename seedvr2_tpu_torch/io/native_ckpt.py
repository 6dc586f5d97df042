"""The converted-weights cache (counterpart of seedvr2_tpu/io/native_ckpt.py).

A reference checkpoint is converted on its first load (io/weights.py: key
map, transform, int8 quantization, the cast to each leaf's load type) and
the result is kept in ``<model_dir>/torch_cache/``: one safetensors file
per source file and settings, holding the flat JAX-path dict that the
modules load from, whole (a tensor rank takes its slice as it reads), each
leaf in the type ``Leaf.set_jax`` casts it to. Later loads read that file
tensor by tensor, so a cached load is a plain read and gives the same
buffers bit for bit.

The file's ``__metadata__`` holds its key: the source's size and mtime,
the settings (compute dtype, quantize, a fingerprint of the key map and of
the leaves' names, types and shapes, which the config decides) and the
format version. A key that
does not match the source and settings, or a file that cannot be read, is
converted again and replaced; a cache that cannot be written leaves the
load to go on without it. Each case prints a forced log line.

The file is written under a temporary name, synced, and renamed into
place (``os.replace``), so a killed run, a crash, or two ranks converting
at once leave one whole file or none under the cache's name, and no
reader sees a file being written. A killed run's temporary
(``<cache>.<pid>.<hex>.tmp``) is removed by the next conversion of the
same file once no process of that pid is alive on this host.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import struct
import uuid
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.debug import Debug

FORMAT = "1"
CACHE_DIR = "torch_cache"

_SAFETENSORS_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32", torch.int8: "I8"}

Layout = Sequence[Tuple[str, torch.dtype, Tuple[int, ...]]]  # (flat path, load type, whole shape), in file order


def cache_path(model_path: str, tag: str) -> str:
    """``<dir of model_path>/torch_cache/<file name>.<tag>.safetensors``."""
    d, name = os.path.split(os.path.abspath(model_path))
    return os.path.join(d, CACHE_DIR, f"{name}.{tag}.safetensors")


def cache_key(model_path: str, settings: Dict[str, str]) -> Dict[str, str]:
    """What a cache file must hold in its metadata to stand for
    ``model_path`` converted under ``settings`` (all values strings)."""
    st = os.stat(model_path)
    return {"format": FORMAT, "source_size": str(st.st_size), "source_mtime_ns": str(st.st_mtime_ns), **settings}


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:  # another user's process: alive
        pass
    return True


def _remove_stray_temporaries(path: str) -> None:
    """Removes the temporaries of cache file ``path`` that killed
    conversions left: those whose writer's pid is no longer alive."""
    d, name = os.path.split(path)
    stray = re.compile(re.escape(name) + r"\.(\d+)\.[0-9a-f]{8}\.tmp")
    for entry in os.listdir(d):
        m = stray.fullmatch(entry)
        if m and not _alive(int(m.group(1))):
            try:
                os.remove(os.path.join(d, entry))
            except OSError:
                pass


class CacheWriter:
    """A safetensors file written one tensor at a time, in any order: the
    header (every name, type and shape of ``layout``, and ``metadata``)
    first, then each tensor's bytes at its offset. ``commit`` renames the
    whole file into place; ``abort`` removes it."""

    def __init__(self, path: str, layout: Layout, metadata: Dict[str, str]):
        header, spans, offset = {"__metadata__": metadata}, {}, 0
        for name, dtype, shape in layout:
            n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            header[name] = {"dtype": _SAFETENSORS_DTYPES[dtype], "shape": list(shape), "data_offsets": [offset,
                                                                                                        offset + n]}
            spans[name] = (offset, dtype, tuple(shape))
            offset += n
        raw = json.dumps(header, separators=(",", ":")).encode()
        raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned, as safetensors writes it
        self.path, self.tmp = path, f"{path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        self._spans, self._left, self._base = spans, set(spans), 8 + len(raw)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _remove_stray_temporaries(path)
        self._f = open(self.tmp, "wb")
        try:
            self._f.write(struct.pack("<Q", len(raw)) + raw)
        except OSError:
            self.abort()
            raise

    def add(self, name: str, t: torch.Tensor) -> None:
        offset, dtype, shape = self._spans[name]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"cache leaf {name}: {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}")
        self._f.seek(self._base + offset)
        self._f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy())
        self._left.discard(name)

    def commit(self) -> None:
        if self._left:
            raise ValueError(f"cache {self.path}: {len(self._left)} leaves never written, e.g. {sorted(self._left)[:3]}")
        self._f.flush()
        os.fsync(self._f.fileno())  # the bytes on disk before the name: a crash leaves no file of the right key
        self._f.close()
        os.replace(self.tmp, self.path)

    def abort(self) -> None:
        self._f.close()
        try:
            os.remove(self.tmp)
        except OSError:
            pass


def load_or_convert(
    model_path: str,
    layout: Layout,
    settings: Dict[str, str],
    convert: Callable[[Callable[[str, torch.Tensor], None]], object],
    read: Callable[[Callable[[str], torch.Tensor]], object],
    debug: Optional[Debug] = None,
    category: str = "info",
):
    """The cache's reading of ``model_path`` if it is fresh, else its
    conversion, written to the cache on the way.

    ``convert(sink)`` converts the source and returns the loaded object,
    calling ``sink(path, tensor)`` once for every leaf of ``layout`` (whole,
    in its load type). ``read(get)`` returns the same object from
    ``get(path)``, the cached tensor. ``settings``: ``settings_for``'s;
    the file is ``cache_path(model_path, settings["tag"])``."""
    from safetensors import SafetensorError, safe_open

    debug = debug or Debug()
    path = cache_path(model_path, settings["tag"])
    key = cache_key(model_path, settings)
    if os.path.exists(path):
        try:
            with safe_open(path, framework="pt") as f:
                found = f.metadata() or {}
                if found == key:
                    result = read(f.get_tensor)
                    debug.log(f"Weights cache: read {path} ({os.path.getsize(path) / 2**30:.2f} GiB)",
                              category=category, force=True)
                    return result
            stale = sorted(k for k in set(key) | set(found) if key.get(k) != found.get(k))
            debug.log(f"Weights cache: {path} is stale ({', '.join(stale)} differ); converting {model_path} again",
                      category=category, force=True)
        except (SafetensorError, OSError) as e:  # a truncated, corrupt or foreign file: convert, replace it
            debug.log(f"Weights cache: {path} is unreadable ({type(e).__name__}: {e}); converting {model_path} "
                      f"again", category=category, force=True)
    try:
        writer = CacheWriter(path, layout, key)
    except OSError as e:
        debug.log(f"Weights cache: cannot write {path} ({e}); loading without it", category=category, force=True)
        return convert(lambda name, t: None)
    failed = []

    def sink(name: str, t: torch.Tensor) -> None:
        if failed:
            return
        try:
            writer.add(name, t)
        except OSError as e:
            failed.append(e)
            writer.abort()

    try:
        result = convert(sink)
    except BaseException:
        if not failed:
            writer.abort()
        raise
    if not failed:
        try:
            writer.commit()
        except OSError as e:
            failed.append(e)
            writer.abort()
    if failed:
        debug.log(f"Weights cache: writing {path} failed ({failed[0]}); loaded without it", category=category,
                  force=True)
    else:
        debug.log(f"Weights cache: converted {model_path} and wrote {path} "
                  f"({os.path.getsize(path) / 2**30:.2f} GiB)", category=category, force=True)
    return result


def settings_for(kind: str, key_map, dtype: torch.dtype, quantize: Optional[str], layout: Layout) -> Dict[str, str]:
    """The key's settings for a DiT or VAE (``kind``) converted to
    ``dtype`` with ``quantize``; ``tag`` names the file. ``config`` is a
    fingerprint of what the model's config decides about its weights: the
    key map (source key and transform of each leaf) and the leaves' names,
    load types and shapes."""
    dtype_name = str(dtype).replace("torch.", "")
    leaves = [(name, str(dt), list(shape)) for name, dt, shape in layout]
    blob = json.dumps([kind, sorted(key_map.items()), leaves]).encode()
    return {"kind": kind, "dtype": dtype_name, "quantize": quantize or "none",
            "config": hashlib.sha256(blob).hexdigest()[:16],
            "tag": dtype_name + (f".{quantize}" if quantize else "")}
