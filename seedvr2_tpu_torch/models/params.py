"""Parameter leaves shared by the VAE and DiT modules.

The port's modules are named after the JAX package's parameter tree
(``encoder/down0/resnets/1/conv2/w`` is ``vae.encoder.down0.resnets[1]
.conv2.w``), so one flat path -> array dict loads either package. A
``Leaf`` holds the tensors of one node of that tree as buffers (the system
is inference-only: no parameters, no autograd) and converts a JAX-layout
array to its own layout once, at load.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# init kinds of the JAX package's init_params / init_vae_params
NORMAL, ZEROS, ONES, ONES_PLUS_NORMAL, IDENTITY_TILE = "normal", "zeros", "ones", "1+normal", "identity"


class Leaf(nn.Module):
    """spec: leaf name -> (shape in the JAX layout, (init kind, scale))."""

    def __init__(self, spec: Dict[str, Tuple[tuple, tuple]], device, dtype):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        for name, (shape, _) in spec.items():
            self.register_buffer(
                name, torch.empty(self.stored_shape(name, shape), dtype=self.stored_dtype(name), device=device)
            )

    def stored_shape(self, name: str, shape: tuple) -> tuple:
        return shape

    def stored_dtype(self, name: str):
        return self.dtype

    def convert(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """JAX layout -> stored layout."""
        return t

    def set_jax(self, name: str, arr) -> None:
        if name not in self.spec:
            raise KeyError(f"{type(self).__name__} has no leaf {name!r}")
        buf = getattr(self, name)
        t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor) else arr)
        if tuple(t.shape) != tuple(self.spec[name][0]):
            raise ValueError(f"leaf {name}: shape {tuple(t.shape)}, expected {self.spec[name][0]}")
        # round to the compute dtype first, as the JAX loader casts every leaf
        buf.copy_(self.convert(name, t.to(device=buf.device, dtype=self.dtype)))


def linear_spec(din: int, dout: int, bias: bool = True) -> Dict:
    spec = {"w": ((din, dout), (NORMAL, din**-0.5))}
    if bias:
        spec["b"] = ((dout,), (ZEROS, 0.0))
    return spec


class Linear(Leaf):
    """y = x @ w + b with w [din, dout] (the JAX layout)."""

    def __init__(self, din: int, dout: int, device, dtype, bias: bool = True):
        super().__init__(linear_spec(din, dout, bias), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y + self.b if "b" in self.spec else y


def branch(group: nn.ModuleDict, name: str) -> nn.Module:
    """The shared weights ('all') when the layer has them, else the stream's."""
    return group["all"] if "all" in group else group[name]


def _resolve(root: nn.Module, parts) -> nn.Module:
    m = root
    for p in parts:
        if isinstance(m, nn.ModuleList):
            m = m[int(p)]
        elif isinstance(m, nn.ModuleDict):
            m = m[p]
        else:
            m = getattr(m, p)
    return m


def leaf_paths(root: nn.Module):
    for name, m in root.named_modules():
        if isinstance(m, Leaf):
            prefix = name.replace(".", "/")
            for leaf in m.spec:
                yield f"{prefix}/{leaf}", m, leaf


def prepare(root: nn.Module) -> None:
    for m in root.modules():
        if hasattr(m, "prepare"):
            m.prepare()


def load_flat(root: nn.Module, flat: Mapping[str, object]) -> nn.Module:
    """Fill every leaf of ``root`` from a flat JAX-path dict (the layout of
    io/checkpoint.py:flatten_tree); raises on missing or extra keys."""
    expected = {p for p, _, _ in leaf_paths(root)}
    missing, extra = expected - set(flat), set(flat) - expected
    if missing or extra:
        raise KeyError(f"missing {sorted(missing)[:5]} ({len(missing)}), unexpected {sorted(extra)[:5]} ({len(extra)})")
    for path, arr in flat.items():
        *mods, leaf = path.split("/")
        _resolve(root, mods).set_jax(leaf, arr)
    prepare(root)
    return root


def random_leaves(root: nn.Module, generator: torch.Generator):
    """(path, module, leaf, fp32 tensor in the JAX layout) for every leaf of
    ``root``, drawn on the generator's device with the JAX package's init
    distributions (normal * scale, zero biases, unit norms, ...)."""
    dev = generator.device
    for path, m, leaf in leaf_paths(root):
        shape, (kind, scale) = m.spec[leaf]
        if kind in (NORMAL, ONES_PLUS_NORMAL):
            t = torch.randn(shape, generator=generator, device=dev) * scale
            t = t + 1.0 if kind == ONES_PLUS_NORMAL else t
        elif kind == ZEROS:
            t = torch.zeros(shape, device=dev)
        elif kind == ONES:
            t = torch.ones(shape, device=dev)
        elif kind == IDENTITY_TILE:  # [1, 1, 1, C, r*C] with E[c, r*C + c] = 1
            c = shape[3]
            t = torch.eye(c, device=dev).repeat(1, shape[4] // c).reshape(shape)
        else:
            raise ValueError(kind)
        yield path, m, leaf, t


def init_random(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn on the generator's device (random_leaves)."""
    for _, m, leaf, t in random_leaves(root, generator):
        m.set_jax(leaf, t)
    prepare(root)
    return root
