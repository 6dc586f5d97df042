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

from ..ops import quant

# init kinds of the JAX package's init_params / init_vae_params
NORMAL, ZEROS, ONES, ONES_PLUS_NORMAL, IDENTITY_TILE = "normal", "zeros", "ones", "1+normal", "identity"
SCALES = "int8 scales"  # w_s: drawn with its w_q (random_leaves)


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

    def load_dtype(self, name: str):
        """The type a leaf is cast to at load (the JAX loader's cast)."""
        return self.dtype

    def convert(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """JAX layout -> stored layout."""
        return t

    def jax_value(self, name: str) -> torch.Tensor:
        """The stored leaf back in the JAX layout (the inverse of convert)."""
        return getattr(self, name)

    def set_jax(self, name: str, arr) -> None:
        if name not in self.spec:
            raise KeyError(f"{type(self).__name__} has no leaf {name!r}")
        buf = getattr(self, name)
        t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor) else arr)
        if tuple(t.shape) != tuple(self.spec[name][0]):
            raise ValueError(f"leaf {name}: shape {tuple(t.shape)}, expected {self.spec[name][0]}")
        # round to the compute dtype first, as the JAX loader casts every leaf
        buf.copy_(self.convert(name, t.to(device=buf.device, dtype=self.load_dtype(name))))


def linear_spec(din: int, dout, bias: bool = True, quant: bool = False) -> Dict:
    """w [din, *dout] (or, int8, w_q [din, *dout] and its scales w_s
    [*dout], drawn together from w's init), then b [*dout]."""
    out = tuple(dout) if isinstance(dout, (tuple, list)) else (dout,)
    spec = {"w_q" if quant else "w": ((din, *out), (NORMAL, din**-0.5))}
    if quant:
        spec["w_s"] = (out, (SCALES, 0.0))
    if bias:
        spec["b"] = (out, (ZEROS, 0.0))
    return spec


class Linear(Leaf):
    """y = x @ w + b with w [din, *dout] (the JAX layout; a qkv weight is
    [D, 3, inner]), the output flattened to [..., prod(dout)].

    ``quant``: int8 weight storage (ops/quant.py): w_q is stored [N, K] int8
    (K7's layout, N = prod(dout)), w_s fp32 in its JAX shape; the product
    is ops/quant.linear_apply (K7 on the card)."""

    def __init__(self, din: int, dout, device, dtype, bias: bool = True, quant: bool = False):
        super().__init__(linear_spec(din, dout, bias, quant), device, dtype)

    def stored_shape(self, name, shape):
        return (int(np.prod(shape[1:])), shape[0]) if name == "w_q" else shape

    def stored_dtype(self, name):
        return {"w_q": torch.int8, "w_s": torch.float32}.get(name, self.dtype)

    # the int8 payload and its fp32 scales are kept as they are (the JAX loader's _cast)
    load_dtype = stored_dtype

    def convert(self, name, t):
        return t.reshape(t.shape[0], -1).t() if name == "w_q" else t

    def jax_value(self, name):
        if name == "w_q":
            return self.w_q.t().reshape(self.spec["w_q"][0])
        return getattr(self, name)

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        b = self.b if bias and "b" in self.spec else None
        if quant.is_quantized(self.spec):
            return quant.linear_apply(x.contiguous(), self.w_q, self.w_s, b)
        y = x @ self.w.reshape(self.w.shape[0], -1)
        return y if b is None else y + b.reshape(-1)


def branch(group: nn.ModuleDict, name: str) -> nn.Module:
    """The shared weights ('all') when the layer has them, else the stream's."""
    return group["all"] if "all" in group else group[name]


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


def loaded_tensors(root: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor ``root`` computes with once loaded, by name: its buffers
    and what its modules' ``prepare`` derived from them (K2's folds), which
    a load from the weights cache must reproduce bit for bit."""
    out = dict(root.named_buffers())
    for name, m in root.named_modules():
        if hasattr(m, "prepared_tensors"):
            out.update({f"{name}.{k}": t for k, t in m.prepared_tensors().items()})
    return out


def fill_leaves(root: nn.Module, leaves, tensor_rank: int = 0, tensor_size: int = 1, sink=None) -> nn.Module:
    """Fill every leaf of ``root`` from (flat path, whole array or tensor in
    the JAX layout) pairs, one at a time: each is cast to its leaf's load
    type (the JAX loader's cast), handed whole to ``sink(path, tensor)``
    (the weights cache, io/native_ckpt.py), then sliced to tensor rank
    ``tensor_rank``'s part (parallel/sharding.py:local_slice) and copied
    into the module; then ``prepare``. Raises on an unexpected or a
    missing leaf."""
    from ..parallel.sharding import local_slice

    expected = {p: (m, leaf) for p, m, leaf in leaf_paths(root)}
    seen = set()
    for path, arr in leaves:
        if path not in expected:
            raise KeyError(f"unexpected leaf {path}")
        m, leaf = expected[path]
        t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor) else arr).to(m.load_dtype(leaf))
        if sink is not None:
            sink(path, t)
        m.set_jax(leaf, local_slice(path, t, tensor_rank, tensor_size))
        seen.add(path)
    missing = sorted(set(expected) - seen)
    if missing:
        raise KeyError(f"missing {missing[:5]} ({len(missing)})")
    prepare(root)
    return root


def load_flat(root: nn.Module, flat: Mapping[str, object]) -> nn.Module:
    """Fill every leaf of ``root`` from a flat JAX-path dict (the layout of
    io/checkpoint.py:flatten_tree); raises on missing or extra keys before
    any leaf is filled."""
    expected = {p for p, _, _ in leaf_paths(root)}
    missing, extra = expected - set(flat), set(flat) - expected
    if missing or extra:
        raise KeyError(f"missing {sorted(missing)[:5]} ({len(missing)}), unexpected {sorted(extra)[:5]} ({len(extra)})")
    return fill_leaves(root, flat.items())


def random_leaves(root: nn.Module, generator: torch.Generator):
    """(path, module, leaf, fp32 tensor in the JAX layout) for every leaf of
    ``root``, drawn on the generator's device with the JAX package's init
    distributions (normal * scale, zero biases, unit norms, ...). An int8
    linear's weight is drawn dense, as w would be, and quantized
    (ops/quant.py): its w_q (int8) and w_s follow, as
    quantize_dit_params(init_params(...)) makes them; the draws are those
    of the same module with dense weights."""
    dev = generator.device
    for path, m, leaf in leaf_paths(root):
        shape, (kind, scale) = m.spec[leaf]
        if kind == SCALES:
            continue  # yielded with its w_q
        if leaf == "w_q":
            q = quant.quantize_linear(torch.randn(shape, generator=generator, device=dev) * scale)
            stem = path[: -len("w_q")]
            yield path, m, leaf, q["w_q"]
            yield stem + "w_s", m, "w_s", q["w_s"]
            continue
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
