"""Int8 weight storage (seedvr2_tpu_torch/ops/quant.py, K7's plain version,
the int8 NaDiT) against the JAX package's seedvr2_tpu/ops/quant.py and
nadit_forward on the same numpy inputs, fp32 on the CPU.

quantize_weight is bit-equal (the same fp32 division and round half to
even). The int8 forwards are held at test_torch_dit.py's tolerance
(atol=2e-4, rtol=1e-3): the same quantized weights, products summed in
another order. The tiny configs' block linears are far below the
65,536-element threshold, so these tests quantize at ``min_size=1024``
(every block linear of ``dit_tiny``).
"""

import dataclasses
import json
import re
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

import torch_rank_worker as ranks
from seedvr2_tpu.config import dit_tiny
from seedvr2_tpu.io.weights import flatten_tree as j_flatten_tree
from seedvr2_tpu.models.dit import nadit as jnadit
from seedvr2_tpu.ops import quant as jquant
from seedvr2_tpu.ops.attention import get_attention_backend, set_attention_backend
from seedvr2_tpu_torch import config, conv_ab
from seedvr2_tpu_torch.io.checkpoint import flatten_tree
from seedvr2_tpu_torch.io.weights import dit_from_flat, dit_from_jax, random_dit
from seedvr2_tpu_torch.models.dit import nadit
from seedvr2_tpu_torch.models.params import leaf_paths
from seedvr2_tpu_torch.ops import quant
from seedvr2_tpu_torch.parallel.sharding import shard_flat

TOL = dict(atol=2e-4, rtol=1e-3)
MIN_SIZE = 1024


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(96, 40), (64, 3, 32)])
def test_quantize_weight_is_bit_equal_to_jax(shape):
    """A 2-D weight through quantize_weight, a qkv [D, 3, inner] one through
    quantize_linear (JAX's _quantize_tree reshape); an all-zero column
    keeps a zero scale."""
    w = (np.random.RandomState(0).randn(*shape) * 0.3).astype(np.float32)
    w[:, 1] = 0.0
    ref = jquant._quantize_tree({"w": jnp.asarray(w)}, min_size=1)
    got = quant.quantize_linear(w) if len(shape) == 3 else quant.quantize_weight(w)
    assert got["w_q"].dtype == torch.int8 and got["w_s"].dtype == torch.float32
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(ref["w_q"]))
    np.testing.assert_array_equal(got["w_s"].numpy(), np.asarray(ref["w_s"]))
    deq = quant.dequantize_weight(quant.quantize_linear(w), torch.float32).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jquant.dequantize_weight(ref, jnp.float32)))


@pytest.mark.parametrize("bias", [True, False])
def test_linear_apply_plain_matches_jax(bias):
    """K7's plain version (w_q stored [N, K]) against JAX's linear_apply on
    the same quantized weight, with and without a bias."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 7, 64).astype(np.float32)
    p = jquant._quantize_tree({"w": jnp.asarray(rs.randn(64, 96).astype(np.float32) * 0.1)}, min_size=1)
    if bias:
        p["b"] = jnp.asarray(rs.randn(96).astype(np.float32))
    ref = np.asarray(jquant.linear_apply(p, jnp.asarray(x)))
    w_q = torch.from_numpy(np.asarray(p["w_q"])).t().contiguous()
    b = torch.from_numpy(np.asarray(p["b"])) if bias else None
    got = quant.linear_apply(torch.from_numpy(x), w_q, torch.from_numpy(np.asarray(p["w_s"])), b)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_linear_apply_on_the_cpu_counts_no_launch():
    counts = lambda: (quant.linear_apply.launches, quant.linear_apply.launches_wgmma,  # noqa: E731
                      quant.linear_apply.launches_splitk, dict(quant.linear_apply.launches_by_shape))
    n0 = counts()
    quant.linear_apply(torch.ones(3, 64), torch.ones(128, 64, dtype=torch.int8), torch.ones(128))
    assert counts() == n0


@pytest.mark.parametrize("M,kind", [(1, "splitk"), (58, "splitk"), (64, "splitk"), (65, "wgmma"), (128, "wgmma"),
                                    (129, "wgmma"), (7200, "wgmma"), (24480, "wgmma")])
def test_k7_regime_by_rows(M, kind):
    """The text rows (M <= 64: 58 in every run) take split-K, the video
    rows wgmma; a pure function of M."""
    assert quant.regime(M) == kind


def test_k7_text_rows_are_the_kernel_headers():
    """The wrapper's row threshold is the split-K kernel's kTextRows
    (csrc/w8a16_linear.cuh), which the C entry checks M against."""
    header = (Path(quant.__file__).parent.parent / "csrc" / "w8a16_linear.cuh").read_text()
    assert int(re.search(r"constexpr int kTextRows = (\d+);", header).group(1)) == quant.TEXT_ROWS


@pytest.mark.parametrize("variant", ["3b", "7b"])
def test_k7_row_shapes_are_the_int8_linears(variant):
    """conv_ab.int8_linear_shapes (K7's rows there and in chip_smoke.py's
    phase 3) gives exactly the (K, N) of the block linears that
    quantize="int8" stores as int8, N flattened as K7 reads it."""
    cfg = config.dit_3b() if variant == "3b" else config.dit_7b()
    dense = nadit.NaDiT(cfg, "meta", torch.bfloat16)
    got = set()
    for p, m, leaf in leaf_paths(dense):
        shape = tuple(m.spec[leaf][0])
        if quant.quantizes(p, shape):
            got.add((shape[0], int(np.prod(shape[1:]))))
    assert got == {(K, N) for _, K, N, _ in conv_ab.int8_linear_shapes(cfg)}


def test_k7_reset_launches_zeroes_every_count(monkeypatch):
    monkeypatch.setattr(quant.linear_apply, "launches", 5)
    monkeypatch.setattr(quant.linear_apply, "launches_wgmma", 3)
    monkeypatch.setattr(quant.linear_apply, "launches_splitk", 2)
    monkeypatch.setattr(quant.linear_apply, "launches_by_shape", {(58, 64, 128): 2})
    quant.reset_launches()
    assert (quant.linear_apply.launches, quant.linear_apply.launches_wgmma, quant.linear_apply.launches_splitk,
            quant.linear_apply.launches_by_shape) == (0, 0, 0, {})


@pytest.mark.parametrize("rope_type", ["mmrope3d", "window_pixel"])
def test_quantize_dit_params_equals_jax(rope_type):
    """Same paths, shapes, dtypes and values as JAX's quantize_dit_params on
    dit_tiny 3B-style (SwiGLU, shared and video-only layers) and 7B-style
    (window_pixel, the GELU MLP with biases)."""
    cfg = dit_tiny(rope_type)
    params = _np(jnadit.init_params(cfg, jax.random.PRNGKey(0)))
    ref = j_flatten_tree(_np(jquant.quantize_dit_params(params, MIN_SIZE)))
    got = quant.quantize_dit_params(flatten_tree(params), MIN_SIZE)
    assert sorted(got) == sorted(ref)
    assert sum(k.endswith("/w_q") for k in got) > 0 and not any(k.startswith(("vid_in", "txt_in")) and "w_q" in k
                                                              for k in got)
    for k, v in got.items():
        v = np.asarray(v)
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k])
    assert quant.tree_bytes(got) == jquant.tree_bytes(jquant.quantize_dit_params(params, MIN_SIZE))


@pytest.mark.parametrize("rope_type", ["mmrope3d", "window_pixel"])
def test_int8_leaves_sit_where_jax_quantizes(rope_type, monkeypatch):
    """NaDiT(int8=int8_linears(cfg)) has int8 leaves exactly at
    quantize_dit_params's paths, at the default threshold too (none in the
    tiny config, all block linears of 3B and 7B)."""
    cfg = dit_tiny(rope_type)
    params = _np(jnadit.init_params(cfg, jax.random.PRNGKey(0)))
    for min_size in (MIN_SIZE, quant._QUANT_MIN_SIZE):
        want = set(j_flatten_tree(_np(jquant.quantize_dit_params(params, min_size))))
        monkeypatch.setattr(quant, "_QUANT_MIN_SIZE", min_size)
        pcfg = config.dit_tiny(rope_type)
        model = nadit.NaDiT(pcfg, "meta", torch.float32, int8=nadit.int8_linears(pcfg))
        assert {p for p, _, _ in leaf_paths(model)} == want
    monkeypatch.undo()
    for cfg in (config.dit_3b(), config.dit_7b()):
        model = nadit.NaDiT(cfg, "meta", torch.bfloat16, int8=nadit.int8_linears(cfg))
        linears = [p for p, _, _ in leaf_paths(model) if p.startswith("blocks/") and p.endswith(("/w", "/w_q"))
                   and "norm" not in p]
        assert linears and all(p.endswith("/w_q") for p in linears)


def _dequantized(tree):
    """A quantized JAX tree with every (w_q, w_s) replaced by w = w_q * w_s
    (fp32): the same weights, dense."""
    if isinstance(tree, dict):
        if "w_q" in tree:
            out = {k: v for k, v in tree.items() if k not in ("w_q", "w_s")}
            out["w"] = np.asarray(jquant.dequantize_weight(tree, jnp.float32))
            return out
        return {k: _dequantized(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dequantized(v) for v in tree]
    return tree


@pytest.mark.parametrize("backend", ["fused", "xla", "pallas", "fused_int8"])
@pytest.mark.parametrize("rope_type", ["mmrope3d", "window_pixel"])
def test_int8_nadit_forward_matches_jax(rope_type, backend):
    """The int8 NaDiT against JAX's nadit_forward on the same quantized tree,
    under fused, sdpa (xla), flash_attn_2 (pallas) and sageattn_2
    (fused_int8).

    Under fused_int8 K3q rounds q and k to int8, which turns a 1e-7
    difference in a projection into a whole int8 step where a value sits on
    a rounding boundary: JAX's own forward on the int8 tree and on the same
    weights dequantized (w_q * w_s, dense) differ in 7 of 12,288 outputs by
    up to 1.3e-3 (mmrope3d), and the port's int8 forward meets the latter
    at the tolerance. So under fused_int8 the port is held at the tolerance
    against JAX's forward on the dequantized tree, and against the int8
    tree's with at most 0.1% of the outputs off by at most 5e-3."""
    cfg = dit_tiny(rope_type)
    thw, txt_len, B = (2, 6, 8), 3, 2
    params = jquant.quantize_dit_params(_perturbed(jnadit.init_params(cfg, jax.random.PRNGKey(3)), 4), MIN_SIZE)
    rs = np.random.RandomState(5)
    vid = (rs.randn(B, thw[0], thw[1] * 2, thw[2] * 2, cfg.vid_in_channels) * 0.4).astype(np.float32)
    txt = (rs.randn(B, txt_len, cfg.txt_in_dim) * 0.4).astype(np.float32)
    t = np.full((B,), 700.0, np.float32)
    prev = get_attention_backend()
    set_attention_backend(backend)
    try:
        refs = [np.asarray(jnadit.nadit_forward(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(vid),
                                                jnp.asarray(txt), jnp.asarray(t),
                                                jnadit.build_attn_plans(cfg, thw, txt_len)))
                for tree in ((params, _dequantized(params)) if backend == "fused_int8" else (params,))]
    finally:
        set_attention_backend(prev)
    pcfg = config.dit_tiny(rope_type)
    model = dit_from_jax(_np(params), pcfg, "cpu", torch.float32).set_attention_mode(backend)
    assert model.quantize == "int8" and model.blocks[0].attn.qkv["vid"].w_q.dtype == torch.int8
    dplans = nadit.device_plans(nadit.build_attn_plans(pcfg, thw, txt_len), pcfg.head_dim, "cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(vid), torch.from_numpy(txt), torch.from_numpy(t), dplans).numpy()
    np.testing.assert_allclose(got, refs[-1], **TOL)
    if backend == "fused_int8":
        off = np.abs(got - refs[0]) > TOL["atol"] + TOL["rtol"] * np.abs(refs[0])
        assert off.mean() <= 1e-3 and np.abs(got - refs[0]).max() <= 5e-3


def _row_parallel_absmax_across_ranks(flat, cfg):
    """Scale the rows of every row-parallel weight (attn/out, mlp proj_out)
    so that even columns take their absmax in the second half of the
    contraction axis and odd columns in the first: with tensor=2 each
    column's absmax lies in one rank's half, and a rank that quantized its
    half alone would get another scale."""
    out = dict(flat)
    for k, v in flat.items():
        if k.endswith("/w") and ("attn/out" in k or "proj_out" in k):
            v = np.array(v, np.float32)
            h = v.shape[0] // 2
            v[h:, 0::2] *= 8.0
            v[:h, 1::2] *= 8.0
            out[k] = v
    return out


def test_tensor_split_keeps_the_unsharded_scales():
    """Quantize the whole weight, then slice: each rank's w_q and w_s are
    the unsharded tree's slices, equal on both ranks for a row-parallel
    layer; quantizing a rank's slice alone would not give them."""
    cfg = config.dit_tiny()
    flat = _row_parallel_absmax_across_ranks(flatten_tree(_np(jnadit.init_params(dit_tiny(), jax.random.PRNGKey(0)))),
                                             cfg)
    whole = quant.quantize_dit_params(flat, MIN_SIZE)
    parts = [shard_flat(whole, cfg, r, 2) for r in range(2)]
    key = "blocks/0/attn/out/vid/w_s"
    for p in parts:
        np.testing.assert_array_equal(p[key].numpy(), whole[key].numpy())
    np.testing.assert_array_equal(torch.cat([p["blocks/0/attn/out/vid/w_q"] for p in parts]).numpy(),
                                  whole["blocks/0/attn/out/vid/w_q"].numpy())
    gate = "blocks/0/mlp/vid/proj_in_gate/w_s"
    np.testing.assert_array_equal(torch.cat([p[gate] for p in parts]).numpy(), whole[gate].numpy())
    qkv = "blocks/0/attn/qkv/vid/w_s"
    np.testing.assert_array_equal(torch.cat([p[qkv] for p in parts], dim=1).numpy(), whole[qkv].numpy())
    alone = quant.quantize_linear(shard_flat(flat, cfg, 0, 2)["blocks/0/attn/out/vid/w"])["w_s"]
    assert not torch.equal(alone, whole[key])


@pytest.fixture(scope="module")
def tensor2_int8(tmp_path_factory):
    """The tiny 3B-style int8 DiT on two gloo ranks (tensor=2), weights
    quantized whole then sliced in each rank, against JAX's unsharded int8
    forward on the same tree."""
    d = tmp_path_factory.mktemp("tensor2_int8")
    cfg = dit_tiny()
    flat = _row_parallel_absmax_across_ranks(
        flatten_tree(_perturbed(jnadit.init_params(cfg, jax.random.PRNGKey(7)), 8)), config.dit_tiny())
    rs = np.random.RandomState(9)
    thw, txt_len, B = (2, 6, 8), 3, 1
    vid = (rs.randn(B, thw[0], thw[1] * 2, thw[2] * 2, cfg.vid_in_channels) * 0.4).astype(np.float32)
    txt = (rs.randn(B, txt_len, cfg.txt_in_dim) * 0.4).astype(np.float32)
    t = np.full((B,), 700.0, np.float32)
    inputs = {f"p/{k}": np.asarray(v, np.float32) for k, v in flat.items()}
    inputs.update({"x/vid": vid, "x/txt": txt, "x/t": t})
    np.savez(d / "inputs.npz", **inputs)
    cases = [{"name": f"int8_{mode}", "mesh": [1, 1, 2], "rope": "mmrope3d", "mode": mode, "params": "p",
              "inputs": "x", "quantize_min_size": MIN_SIZE} for mode in ("fused", "flash_attn_2")]
    (d / "cases.json").write_text(json.dumps(cases))
    proc = ranks.start("dit", d, 2)
    tree = jquant.quantize_dit_params(_unflatten(flat, jnadit.init_params(cfg, jax.random.PRNGKey(7))), MIN_SIZE)
    refs = {}
    for mode, jmode in (("fused", "fused"), ("flash_attn_2", "pallas")):
        prev = get_attention_backend()
        set_attention_backend(jmode)
        try:
            refs[f"int8_{mode}"] = np.asarray(jnadit.nadit_forward(
                jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(t),
                jnadit.build_attn_plans(cfg, thw, txt_len)))
        finally:
            set_attention_backend(prev)
    return ranks.finish(proc, d, 2), refs


def _unflatten(flat, template):
    from seedvr2_tpu.io.weights import unflatten_into

    return unflatten_into(template, flat)


@pytest.mark.parametrize("mode", ["fused", "flash_attn_2"])
def test_tensor2_int8_forward_matches_jax_unsharded(tensor2_int8, mode):
    got, refs = tensor2_int8
    np.testing.assert_allclose(got[f"int8_{mode}"], refs[f"int8_{mode}"], **TOL)


def _random_int8(cfg, generator):
    """random_dit(..., quantize="int8") at MIN_SIZE."""
    with mock.patch.object(quant, "_QUANT_MIN_SIZE", MIN_SIZE):
        return random_dit(cfg, generator, torch.float32, quantize="int8")


def test_random_int8_dit_is_the_dense_draws_quantized():
    """random_dit(quantize="int8") draws what the dense random_dit draws and
    quantizes it (the same generator state after every leaf)."""
    cfg = config.dit_tiny()
    dense = random_dit(cfg, torch.Generator().manual_seed(3), torch.float32)
    q = _random_int8(cfg, torch.Generator().manual_seed(3))
    for path, m, leaf in leaf_paths(q):
        if leaf == "w_q":
            want = quant.quantize_linear(dense.get_submodule(path[: -len("/w_q")].replace("/", ".")).w)
            np.testing.assert_array_equal(m.jax_value("w_q").numpy(), want["w_q"].numpy())
            np.testing.assert_array_equal(m.w_s.numpy(), want["w_s"].numpy())
        elif leaf != "w_s":
            mod = dense.get_submodule(path.rsplit("/", 1)[0].replace("/", "."))
            np.testing.assert_array_equal(getattr(m, leaf).numpy(), getattr(mod, leaf).numpy())
    assert quant.tree_bytes(q) < quant.tree_bytes(dense) / 2


def test_dit_from_flat_round_trips_int8_leaves():
    """jax_value gives back the JAX layout of an int8 leaf, and a module
    rebuilt from those values is the same: int8 where the dict holds a
    w_q, whatever threshold made it (here MIN_SIZE, not _QUANT_MIN_SIZE)."""
    q = _random_int8(config.dit_tiny("window_pixel"), torch.Generator().manual_seed(4))
    flat = {p: m.jax_value(leaf) for p, m, leaf in leaf_paths(q)}
    again = dit_from_flat(flat, q.cfg, "cpu", torch.float32)
    for (p, m, leaf), (_, m2, _) in zip(leaf_paths(q), leaf_paths(again)):
        assert torch.equal(getattr(m, leaf), getattr(m2, leaf)), p
    assert dataclasses.asdict(again.cfg) == dataclasses.asdict(q.cfg) and again.quantize == "int8"


def test_quantize_rejects_other_values():
    with pytest.raises(ValueError, match="int8"):
        random_dit(config.dit_tiny(), torch.Generator(), torch.float32, quantize="fp8")


@pytest.mark.parametrize("variant", ["3b", "7b"])
def test_k7_takes_every_int8_linear_of_each_tensor_split(variant):
    """Each rank's int8 linears, at every tensor axis of up to 4 that
    check_tensor_split accepts, have widths that K7 takes
    (quant.check_shape, which linear_apply calls on the card). 3B at
    tensor=4 gives its MLP 6912 / 4 = 1728 columns: 13 and a half
    128-column tiles."""
    cfg = config.dit_3b() if variant == "3b" else config.dit_7b()
    int8 = nadit.int8_linears(cfg)
    widths = set()
    for tensor in (1, 2, 4):
        model = nadit.NaDiT(cfg, "meta", torch.bfloat16, tensor=tensor, int8=int8)
        for p, m, leaf in leaf_paths(model):
            if leaf == "w_q":
                N, K = m.w_q.shape
                quant.check_shape(N, K)
                widths.add((tensor, "/".join(p.split("/")[2:-1]), N, K))
    assert {w[0] for w in widths} == {1, 2, 4} and {"attn/qkv/vid", "attn/out/vid"} <= {w[1] for w in widths}
    if variant == "3b":
        assert {(4, "mlp/vid/proj_in", 1728, 2560), (4, "mlp/vid/proj_out", 2560, 1728)} <= widths


def test_runner_counts_int8_bytes_and_moves_int8_weights():
    """weight_bytes (the run budget's resident weights) counts an int8
    leaf at 1 byte; release_dit / ensure_dit_resident keep its type."""
    import dataclasses as dc

    from seedvr2_tpu_torch.io.weights import random_vae
    from seedvr2_tpu_torch.pipeline.runner import Runner

    vc = config.vae_tiny()
    dcfg = dc.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1, vid_out_channels=vc.latent_channels)
    cfg = config.PipelineConfig(dit=dcfg, vae=vc, compute_dtype="float32", phased_weights=True)
    g = torch.Generator().manual_seed(0)
    dit = _random_int8(dcfg, g)
    vae = random_vae(vc, g, torch.float32)
    runner = Runner(cfg, dit, vae, np.zeros((4, dcfg.txt_in_dim), np.float32), device="cpu")
    assert runner.weight_bytes() == quant.tree_bytes(dit) + quant.tree_bytes(vae)
    dense = random_dit(dcfg, torch.Generator().manual_seed(0), torch.float32)
    assert quant.tree_bytes(dit) < quant.tree_bytes(dense) / 2
    runner.release_dit()
    runner.ensure_dit_resident()
    assert dit.blocks[0].attn.qkv["vid"].w_q.dtype == torch.int8 and dit.blocks[0].attn.qkv["vid"].w_s.dtype == torch.float32
