"""The Megatron split of the DiT's weights over the "tensor" axis
(counterpart of seedvr2_tpu/parallel/sharding.py).

``leaf_spec`` is the JAX package's ``_dit_leaf_spec`` rule, leaf for leaf:
qkv column-parallel by head, ``attn/out`` row-parallel, ``mlp`` proj_in and
proj_in_gate column-parallel, ``mlp`` proj_out row-parallel, in the vid and
txt branches and in the shared ("all") and video-only layers alike;
everything else replicated (and the VAE whole). Where GSPMD keeps a
column-parallel layer's 1-D bias replicated and slices it at the add, the
port slices it at load (``local_slice``). A row-parallel layer's bias stays
whole; the forward adds it once, after the sum over the tensor group.

An int8 weight (ops/quant.py) splits like the dense one: ``w_q`` as ``w``,
and the per-column scales ``w_s`` follow their columns (qkv's [3, inner] on
axis 1, the MLP's proj_in / proj_in_gate [hidden] on axis 0); a
row-parallel layer's scales [D] stay whole. The whole weight is quantized
first and then sliced (io/weights.py, ``shard_dit``), as the JAX package
quantizes the whole tree before GSPMD shards it: a row-parallel column's
absmax runs over the split axis, so a slice quantized alone would get
another scale.

The weights are sliced where they lie: on the host when they come from a
checkpoint (pipeline/loader.py), so that a rank's card only ever holds its
part, which is what the tensor axis is for (7B).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ..config import DiTConfig
from .mesh import AXIS_TENSOR, Mesh


def leaf_spec(path: str, ndim: int) -> Tuple:
    """The partition of one DiT leaf (flat JAX path, e.g.
    ``blocks/3/attn/qkv/vid/w``): one entry per axis, "tensor" on the split
    axis; () for a replicated leaf."""
    if ndim < 2:
        return ()
    if "attn/qkv" in path:
        return (None, None, AXIS_TENSOR) if ndim == 3 else (None, AXIS_TENSOR)
    if "attn/out" in path:
        return (AXIS_TENSOR, None)
    if "mlp" in path and "proj_out" in path:
        return (AXIS_TENSOR, None)
    if "mlp" in path and ("proj_in" in path or "proj_in_gate" in path):
        return (None, AXIS_TENSOR)
    return ()


def _split_axis(path: str, ndim: int):
    spec = leaf_spec(path, ndim)
    if AXIS_TENSOR in spec:
        return spec.index(AXIS_TENSOR)
    if ndim == 1 and "mlp" in path and "proj_in" in path and path.endswith(("/b", "/w_s")):
        return 0  # a column-parallel bias, or int8 scale, follows its columns
    return None


def local_slice(path: str, arr, tensor_rank: int, tensor_size: int):
    """This tensor rank's part of one leaf (numpy array or tensor; a view)."""
    axis = _split_axis(path, arr.ndim)
    if axis is None or tensor_size == 1:
        return arr
    n = arr.shape[axis]
    if n % tensor_size:
        raise ValueError(f"{path}: axis {axis} of size {n} does not split over tensor={tensor_size}")
    part = n // tensor_size
    index = [slice(None)] * arr.ndim
    index[axis] = slice(tensor_rank * part, (tensor_rank + 1) * part)
    return arr[tuple(index)]


def check_tensor_split(cfg: DiTConfig, tensor: int) -> None:
    """Raise ValueError unless the heads and the MLP width split evenly
    over ``tensor`` ranks. The JAX package instead runs K3 unsharded when
    the heads do not divide (fused_window_attention.py:252-257); the port
    refuses the mesh, so that a tensor axis always means split weights."""
    from ..models.dit.nadit import mlp_hidden

    if tensor < 1 or cfg.heads % tensor:
        raise ValueError(f"heads={cfg.heads} do not split over tensor={tensor}")
    if mlp_hidden(cfg) % tensor:
        raise ValueError(f"MLP width {mlp_hidden(cfg)} does not split over tensor={tensor}")


def shard_flat(flat: Mapping[str, object], cfg: DiTConfig, tensor_rank: int, tensor_size: int) -> Dict[str, object]:
    """A flat JAX-path dict of the whole DiT -> this tensor rank's part."""
    check_tensor_split(cfg, tensor_size)
    return {k: local_slice(k, v, tensor_rank, tensor_size) for k, v in flat.items()}


def shard_dit(dit, mesh: Mesh):
    """A NaDiT holding this rank's part of ``dit``'s weights over the mesh's
    tensor axis (``dit`` itself when the axis is 1). The slices are copied
    on ``dit``'s device; drop ``dit`` afterwards to free the whole weights."""
    from ..io.weights import dit_from_flat
    from ..models.params import leaf_paths

    t = mesh.shape[AXIS_TENSOR]
    if t == 1:
        return dit
    if getattr(dit, "tensor", 1) != 1:
        raise ValueError("shard_dit: the DiT is already split")
    dev = dit.vid_in.w.device
    dtype = dit.vid_in.w.dtype
    flat = {p: m.jax_value(leaf) for p, m, leaf in leaf_paths(dit)}
    with torch.inference_mode():
        local = dit_from_flat(shard_flat(flat, dit.cfg, mesh.coord(AXIS_TENSOR), t), dit.cfg, dev, dtype, tensor=t)
    return local.set_attention_mode(dit.attention_backend)  # a backend name is its own alias
