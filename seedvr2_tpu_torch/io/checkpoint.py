"""Reference checkpoints <-> flat parameter dicts in the JAX package's layout
(the port's copy of seedvr2_tpu/io/weights.py: the safetensors read, the
DiT and VAE key maps, convert_state_dict and its inverse export_state_dict,
flatten_tree and load_text_embeddings; same keys, same transforms).

A flat dict maps a '/'-joined path of the JAX parameter tree
(``blocks/3/attn/qkv/vid/w``) to an array; io/weights.py fills the port's
modules from it. Layout conversions:
- torch Linear [out, in]        -> [in, out]       (transpose)
- torch Conv3d [O, I, D, H, W]  -> [D, H, W, I, O]  (transpose 2,3,4,1,0)
- fused qkv [3*inner, D]        -> [D, 3, inner]
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import DiTConfig, VAEConfig

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A safetensors file as host numpy arrays; dtypes numpy cannot hold
    (bf16, fp8_e4m3fn) are read through torch and widened to fp32."""
    from safetensors import safe_open

    out = {}
    needs_torch = []
    with safe_open(path, framework="np") as f:
        for k in f.keys():
            try:
                out[k] = f.get_tensor(k)
            except (TypeError, ValueError):
                needs_torch.append(k)
    if needs_torch:
        import torch

        with safe_open(path, framework="pt") as f:
            for k in needs_torch:
                out[k] = f.get_tensor(k).to(torch.float32).numpy()
    return out


# --------------------------------------------------------------------------- #
# DiT key map
# --------------------------------------------------------------------------- #

_ADA_KEYS = ("attn_shift", "attn_scale", "attn_gate", "mlp_shift", "mlp_scale", "mlp_gate")


def dit_key_map(cfg: DiTConfig) -> Dict[str, Tuple[str, str]]:
    """flat path -> (torch key, transform)."""
    m: Dict[str, Tuple[str, str]] = {
        "vid_in/w": ("vid_in.proj.weight", "linear"),
        "vid_in/b": ("vid_in.proj.bias", "none"),
        "txt_in/w": ("txt_in.weight", "linear"),
        "txt_in/b": ("txt_in.bias", "none"),
        "emb_in/proj_in/w": ("emb_in.proj_in.weight", "linear"),
        "emb_in/proj_in/b": ("emb_in.proj_in.bias", "none"),
        "emb_in/proj_hid/w": ("emb_in.proj_hid.weight", "linear"),
        "emb_in/proj_hid/b": ("emb_in.proj_hid.bias", "none"),
        "emb_in/proj_out/w": ("emb_in.proj_out.weight", "linear"),
        "emb_in/proj_out/b": ("emb_in.proj_out.bias", "none"),
        "vid_out/w": ("vid_out.proj.weight", "linear"),
        "vid_out/b": ("vid_out.proj.bias", "none"),
    }
    if cfg.vid_out_norm:
        m["vid_out_norm/w"] = ("vid_out_norm.weight", "none")
        m["vid_out_ada/vid/out_shift"] = ("vid_out_ada.out_shift", "none")
        m["vid_out_ada/vid/out_scale"] = ("vid_out_ada.out_scale", "none")

    for i in range(cfg.num_layers):
        shared = cfg.shared_weights(i)
        vid_only = cfg.vid_only(i)
        branches = ["all"] if shared else (["vid"] if vid_only else ["vid", "txt"])

        def bset(our_mid, ref_mid, has_bias=True, kind="linear", bias_kind="none", branches=branches):
            for br in branches:
                m[f"blocks/{i}/{our_mid}/{br}/w"] = (f"blocks.{i}.{ref_mid}.{br}.weight", kind)
                if has_bias:
                    m[f"blocks/{i}/{our_mid}/{br}/b"] = (f"blocks.{i}.{ref_mid}.{br}.bias", bias_kind)

        bset("attn/qkv", "attn.proj_qkv", has_bias=cfg.qk_bias, kind="qkv_w", bias_kind="qkv_b")
        bset("attn/out", "attn.proj_out", has_bias=True)
        for br in branches:
            m[f"blocks/{i}/attn/norm_q/{br}/w"] = (f"blocks.{i}.attn.norm_q.{br}.weight", "none")
            m[f"blocks/{i}/attn/norm_k/{br}/w"] = (f"blocks.{i}.attn.norm_k.{br}.weight", "none")

        subs = ("proj_in_gate", "proj_in", "proj_out") if cfg.mlp_type == "swiglu" else ("proj_in", "proj_out")
        for sub in subs:
            for br in branches:
                m[f"blocks/{i}/mlp/{br}/{sub}/w"] = (f"blocks.{i}.mlp.{br}.{sub}.weight", "linear")
                if cfg.mlp_type != "swiglu":
                    m[f"blocks/{i}/mlp/{br}/{sub}/b"] = (f"blocks.{i}.mlp.{br}.{sub}.bias", "none")
        for br in branches:
            for ak in _ADA_KEYS:
                m[f"blocks/{i}/ada/{br}/{ak}"] = (f"blocks.{i}.ada.{br}.{ak}", "none")
    return m


# --------------------------------------------------------------------------- #
# VAE key map
# --------------------------------------------------------------------------- #


def vae_key_map(cfg: VAEConfig) -> Dict[str, Tuple[str, str]]:
    m: Dict[str, Tuple[str, str]] = {}

    def conv(our, ref):
        m[f"{our}/w"] = (f"{ref}.weight", "conv3d")
        m[f"{our}/b"] = (f"{ref}.bias", "none")

    def norm(our, ref):
        m[f"{our}/w"] = (f"{ref}.weight", "none")
        m[f"{our}/b"] = (f"{ref}.bias", "none")

    def lin(our, ref):
        m[f"{our}/w"] = (f"{ref}.weight", "linear")
        m[f"{our}/b"] = (f"{ref}.bias", "none")

    def resnet(our, ref, cin, cout):
        norm(f"{our}/norm1", f"{ref}.norm1")
        conv(f"{our}/conv1", f"{ref}.conv1")
        norm(f"{our}/norm2", f"{ref}.norm2")
        conv(f"{our}/conv2", f"{ref}.conv2")
        if cin != cout:
            conv(f"{our}/conv_shortcut", f"{ref}.conv_shortcut")

    def mid(our, ref, c):
        resnet(f"{our}/resnet0", f"{ref}.resnets.0", c, c)
        resnet(f"{our}/resnet1", f"{ref}.resnets.1", c, c)
        if cfg.mid_block_attention:
            norm(f"{our}/attn/group_norm", f"{ref}.attentions.0.group_norm")
            lin(f"{our}/attn/to_q", f"{ref}.attentions.0.to_q")
            lin(f"{our}/attn/to_k", f"{ref}.attentions.0.to_k")
            lin(f"{our}/attn/to_v", f"{ref}.attentions.0.to_v")
            lin(f"{our}/attn/to_out", f"{ref}.attentions.0.to_out.0")

    boc = cfg.block_out_channels
    conv("encoder/conv_in", "encoder.conv_in")
    cin = boc[0]
    for i in range(cfg.num_blocks):
        cout = boc[i]
        for j in range(cfg.layers_per_block):
            resnet(f"encoder/down{i}/resnets/{j}", f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < cfg.num_blocks - 1:
            conv(f"encoder/down{i}/downsample", f"encoder.down_blocks.{i}.downsamplers.0.conv")
        cin = cout
    mid("encoder/mid", "encoder.mid_block", boc[-1])
    norm("encoder/norm_out", "encoder.conv_norm_out")
    conv("encoder/conv_out", "encoder.conv_out")

    rev = list(reversed(boc))
    conv("decoder/conv_in", "decoder.conv_in")
    mid("decoder/mid", "decoder.mid_block", rev[0])
    cin = rev[0]
    for i in range(cfg.num_blocks):
        cout = rev[i]
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder/up{i}/resnets/{j}", f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < cfg.num_blocks - 1:
            conv(f"decoder/up{i}/upsample/upscale", f"decoder.up_blocks.{i}.upsamplers.0.upscale_conv")
            conv(f"decoder/up{i}/upsample/conv", f"decoder.up_blocks.{i}.upsamplers.0.conv")
        cin = cout
    norm("decoder/norm_out", "decoder.conv_norm_out")
    conv("decoder/conv_out", "decoder.conv_out")
    return m


# --------------------------------------------------------------------------- #
# Tree -> flat, torch layout -> flat layout
# --------------------------------------------------------------------------- #


def flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    """A nested dict/list parameter tree -> {'a/0/b': leaf}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _t_qkv_w(w: np.ndarray) -> np.ndarray:  # [3*inner, D] -> [D, 3, inner]
    out3, d = w.shape
    return np.ascontiguousarray(w.T.reshape(d, 3, out3 // 3))


_TRANSFORMS = {
    "none": lambda x: x,
    "linear": lambda w: np.ascontiguousarray(w.T),
    "conv3d": lambda w: np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0)),
    "qkv_w": _t_qkv_w,
    "qkv_b": lambda b: np.ascontiguousarray(b.reshape(3, -1)),
}


def convert_state_dict(
    state: Dict[str, np.ndarray], key_map: Dict[str, Tuple[str, str]], dtype=np.float32
) -> Dict[str, np.ndarray]:
    """torch state dict -> flat dict in the JAX layout; raises on missing
    keys. ``dtype=None`` keeps each array's own type (the module cast at
    load rounds either way to the same compute-dtype value)."""
    out = {}
    missing = []
    for ours, (theirs, kind) in key_map.items():
        if theirs not in state:
            missing.append(theirs)
            continue
        arr = _TRANSFORMS[kind](np.asarray(state[theirs]))
        out[ours] = arr if dtype is None else arr.astype(dtype)
    if missing:
        raise KeyError(f"Checkpoint missing {len(missing)} keys, e.g. {missing[:5]}")
    return out


def _permuted(x, axes):
    """numpy arrays and torch tensors alike (the export of weights drawn
    on the card stays in torch)."""
    if hasattr(x, "permute"):
        return x.permute(*axes).contiguous()
    return np.ascontiguousarray(np.transpose(np.asarray(x), axes))


_INVERSE = {
    "none": lambda x: x,
    "linear": lambda x: _permuted(x, (1, 0)),
    "conv3d": lambda x: _permuted(x, (4, 3, 0, 1, 2)),
    "qkv_w": lambda x: _permuted(x.reshape(x.shape[0], -1), (1, 0)),
    "qkv_b": lambda x: x.reshape(-1),
}


def export_state_dict(params, key_map: Dict[str, Tuple[str, str]]) -> Dict[str, object]:
    """A parameter tree or flat dict in the JAX layout -> a state dict in the
    reference's torch layout (the inverse of convert_state_dict), numpy or
    torch leaves as given."""
    flat = flatten_tree(params)
    return {theirs: _INVERSE[kind](flat[ours]) for ours, (theirs, kind) in key_map.items()}


def load_text_embeddings(directory: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The fixed prompt embeddings (pos, neg), each [58, 5120]: the model has
    no text encoder at inference. A directory may hold the original
    pos_emb.pt / neg_emb.pt or a text_embeddings.npz; otherwise the copy
    bundled in seedvr2_tpu_torch/assets is read."""
    if directory:
        pos_pt = os.path.join(directory, "pos_emb.pt")
        npz = os.path.join(directory, "text_embeddings.npz")
        if os.path.exists(pos_pt):
            import torch

            pos = torch.load(pos_pt, weights_only=True, map_location="cpu")
            neg = torch.load(os.path.join(directory, "neg_emb.pt"), weights_only=True, map_location="cpu")
            return pos.to(torch.float32).numpy(), neg.to(torch.float32).numpy()
        if os.path.exists(npz):
            data = np.load(npz)
            return data["pos"], data["neg"]
    data = np.load(os.path.join(ASSETS, "text_embeddings.npz"))
    return data["pos"], data["neg"]
