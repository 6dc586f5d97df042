"""The port's multi-rank DiT path vs the JAX package on the conftest's
8-device CPU mesh: the same weights (the JAX init perturbed, handed over as
flat arrays), the same inputs made with numpy, fp32.

- The sharded NaDiT forward on (data, seq, tensor) = (1,2,1), (1,1,2) and
  (1,2,2) under fused (K3s over K3), sdpa and flash_attn_2 (K5) against
  JAX's ``sharded_dit`` forward on a mesh of that shape; windows that do
  not divide the seq axis and fewer windows than seq ranks.
- sageattn_2 (K3q per rank) against JAX's UNSHARDED fused_int8 forward: the
  JAX package's sharded path drops ``quant_qk`` and runs K3 there, which
  the port does not copy. Its bound is stated at ``_int8_bound``: int8
  codes flip on last-bit differences, in the unsharded port as well.
- K3s rank by rank against JAX's ``fused_window_attention_sharded``
  (shard_map, Pallas in interpret mode), padded windows included.
- The mesh policy, the leaf split and the coordinates equal to JAX's.
- The launcher: a failing rank and a stuck one end the launch.

The port's ranks are gloo processes on the CPU started by
parallel/launch.py from tests/torch_rank_worker.py in a fresh interpreter
that imports neither jax nor the JAX package. Forward bound atol=2e-4,
rtol=1e-3, as tests/test_torch_dit.py holds the unsharded forward.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

import torch_rank_worker as ranks
from seedvr2_tpu.config import dit_3b as j_dit_3b
from seedvr2_tpu.config import dit_7b as j_dit_7b
from seedvr2_tpu.config import dit_tiny as j_dit_tiny
from seedvr2_tpu.io.weights import flatten_tree
from seedvr2_tpu.models.dit import nadit as jnadit
from seedvr2_tpu.ops.attention import get_attention_backend, set_attention_backend
from seedvr2_tpu.ops.fused_window_attention import fused_window_attention as j_attn
from seedvr2_tpu.ops.fused_window_attention import fused_window_attention_sharded as j_attn_sharded
from seedvr2_tpu.parallel import mesh as jmesh
from seedvr2_tpu.parallel.sharding import _dit_leaf_spec, dit_param_shardings, shard_params
from seedvr2_tpu.parallel.sp import sharded_dit as j_sharded_dit
from seedvr2_tpu.pipeline.loader import dit_param_bytes as j_dit_param_bytes
from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io.weights import dit_from_jax
from seedvr2_tpu_torch.models.dit import nadit
from seedvr2_tpu_torch.models.params import leaf_paths
from seedvr2_tpu_torch.ops import fused_window_attention as k3
from seedvr2_tpu_torch.parallel import mesh, multihost, sharding
from seedvr2_tpu_torch.pipeline.loader import dit_param_bytes

TOL = dict(atol=2e-4, rtol=1e-3)
JAX_MODE = {"fused": "fused", "sdpa": "xla", "flash_attn_2": "pallas", "sageattn_2": "fused_int8"}
THW, LT, B = (3, 8, 8), 4, 2  # 3 windows in both plans: padded on seq=2, fewer than seq=4


def _perturbed(tree, seed):
    leaves, treedef = jax.tree.flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [np.asarray(l, np.float32) + rs.randn(*np.shape(l)).astype(np.float32) * 0.05 for l in leaves]
    )


def _inputs(cfg, thw, seed):
    rs = np.random.RandomState(seed)
    return {
        "vid": (rs.randn(B, thw[0], thw[1] * 2, thw[2] * 2, cfg.vid_in_channels) * 0.4).astype(np.float32),
        "txt": (rs.randn(B, LT, cfg.txt_in_dim) * 0.4).astype(np.float32),
        "t": np.full((B,), 800.0, np.float32),
    }


PARAMS = {rope: _perturbed(jnadit.init_params(j_dit_tiny(rope), jax.random.PRNGKey(i)), 10 + i)
          for i, rope in enumerate(("mmrope3d", "window_pixel"))}
INPUTS = {"a": _inputs(j_dit_tiny(), THW, 0), "b": _inputs(j_dit_tiny(), (1, 4, 6), 1),
          "c": _inputs(j_dit_tiny("window_pixel"), THW, 2)}

# (name, (data, seq, tensor), rope, mode, inputs); the 2-rank and the 4-rank cases run as two launches
MESH_CASES = [
    (f"{mode}-{d}{s}{t}", (d, s, t), "mmrope3d", mode, "a")
    for mode in ("fused", "sdpa", "flash_attn_2") for d, s, t in ((1, 2, 1), (1, 1, 2), (1, 2, 2))
] + [
    ("window_pixel-fused-122", (1, 2, 2), "window_pixel", "fused", "c"),
    ("fused-141", (1, 4, 1), "mmrope3d", "fused", "a"),  # 3 windows on 4 seq ranks
    ("fused-121-one-window", (1, 2, 1), "mmrope3d", "fused", "b"),  # 1 window on 2
    ("sdpa-141", (1, 4, 1), "mmrope3d", "sdpa", "a"),
    ("load_runner-fused-112", (1, 1, 2), "mmrope3d", "fused", "a"),  # sliced on the host by load_runner
]
INT8_CASES = [
    (f"sageattn_2-{rope}-{d}{s}{t}", (d, s, t), rope, "sageattn_2", "a" if rope == "mmrope3d" else "c")
    for rope in ("mmrope3d", "window_pixel") for d, s, t in ((1, 1, 2), (1, 2, 2), (1, 2, 1))
]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Both launches start at once, in the background; each test waits."""
    inputs = {"text": np.zeros(1, np.float32)}
    for rope, p in PARAMS.items():
        inputs.update({f"{rope}/{k}": v for k, v in flatten_tree(p).items()})
    for key, inp in INPUTS.items():
        inputs.update({f"{key}/{k}": v for k, v in inp.items()})
    runs = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"ranks{n}")
        cases = [dict(name=name, mesh=m, rope=rope, mode=mode, params=rope, inputs=key)
                 for name, m, rope, mode, key in MESH_CASES + INT8_CASES if int(np.prod(m)) == n]
        for case in cases:
            if case["name"].startswith("load_runner"):
                case.update(checkpoint="tiny_dit.safetensors", vae_checkpoint="tiny_vae.safetensors")
                _save_checkpoints(d)
        np.savez(d / "inputs.npz", **inputs)
        (d / "cases.json").write_text(__import__("json").dumps(cases))
        runs[n] = (ranks.start("dit", d, n), d)
    results = {}

    def get(n):
        if n not in results:
            proc, d = runs[n]
            results[n] = ranks.finish(proc, d, n)
        return results[n]

    yield get
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _save_checkpoints(d):
    """The mmrope3d weights and a tiny VAE in the reference's torch layout."""
    from safetensors.numpy import save_file

    from seedvr2_tpu.config import vae_tiny
    from seedvr2_tpu.io import weights as jweights
    from seedvr2_tpu.models.vae.model import init_vae_params

    vae = init_vae_params(vae_tiny(), jax.random.PRNGKey(5))
    for name, p, km in (("tiny_dit.safetensors", PARAMS["mmrope3d"], jweights.dit_key_map(j_dit_tiny())),
                        ("tiny_vae.safetensors", vae, jweights.vae_key_map(vae_tiny()))):
        save_file({k: np.ascontiguousarray(v) for k, v in jweights.export_state_dict(p, km).items()}, str(d / name))


def _jax_forward(rope, key, mode, mesh_shape=None):
    cfg = j_dit_tiny(rope)
    inp = INPUTS[key]
    thw = (inp["vid"].shape[1], inp["vid"].shape[2] // 2, inp["vid"].shape[3] // 2)
    plans = jnadit.build_attn_plans(cfg, thw, LT)
    params = jax.tree.map(jnp.asarray, PARAMS[rope])
    args = tuple(jnp.asarray(inp[k]) for k in ("vid", "txt", "t"))
    prev = get_attention_backend()
    set_attention_backend(mode)
    try:
        if mesh_shape is None:
            return np.asarray(jnadit.nadit_forward(params, cfg, *args, plans))
        m = jmesh.make_mesh(*mesh_shape)

        def f(p, v, tx, ts):
            with j_sharded_dit(m):
                return jnadit.nadit_forward(p, cfg, v, tx, ts, plans)

        return np.asarray(jax.jit(f)(shard_params(params, dit_param_shardings(params, m)), *args))
    finally:
        set_attention_backend(prev)


@pytest.mark.parametrize("name,mesh_shape,rope,mode,key", MESH_CASES, ids=[c[0] for c in MESH_CASES])
def test_sharded_nadit_matches_jax_sharded(port_runs, name, mesh_shape, rope, mode, key):
    ref = _jax_forward(rope, key, JAX_MODE[mode], mesh_shape)
    got = port_runs(int(np.prod(mesh_shape)))[name]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def _int8_bound(got, ref_int8, ref_k3):
    """K3q rounds each q and k row to int8 codes, so a last-bit difference in
    q or k (XLA's fp32 sums against torch's, or a product split over tensor
    ranks) moves a code by one at a few elements and those rows' outputs by
    up to ~2e-3 here: at these inputs the port's UNSHARDED forward misses
    TOL at 0.17% of the elements against JAX's fused_int8 (max 1.9e-3).
    The bound: at most 1% of the elements outside TOL, and a relative L2
    distance to JAX's int8 result under a tenth of the distance between
    JAX's int8 and full-precision (K3) results, so that K3 run in K3q's
    place fails."""
    outside = np.abs(got - ref_int8) > TOL["atol"] + TOL["rtol"] * np.abs(ref_int8)
    rel = np.linalg.norm(got - ref_int8) / np.linalg.norm(ref_int8)
    gap = np.linalg.norm(ref_k3 - ref_int8) / np.linalg.norm(ref_int8)
    assert outside.mean() <= 0.01 and rel < 0.1 * gap, (outside.mean(), rel, gap)


@pytest.mark.parametrize("name,mesh_shape,rope,mode,key", INT8_CASES, ids=[c[0] for c in INT8_CASES])
def test_sharded_sageattn_matches_jax_unsharded_fused_int8(port_runs, name, mesh_shape, rope, mode, key):
    """K3q per rank: held against JAX's unsharded fused_int8 forward (JAX's
    sharded forward would be K3, without int8); bound in _int8_bound, and
    the port's unsharded int8 forward meets it alike."""
    ref, ref_k3 = _jax_forward(rope, key, "fused_int8"), _jax_forward(rope, key, "fused")
    got = port_runs(int(np.prod(mesh_shape)))[name]
    assert got.shape == ref.shape
    _int8_bound(got, ref, ref_k3)
    cfg = config.dit_tiny(rope)
    inp = {k: torch.from_numpy(v) for k, v in INPUTS[key].items()}
    plans = nadit.device_plans(nadit.build_attn_plans(cfg, THW, LT), cfg.head_dim, "cpu")
    model = dit_from_jax(PARAMS[rope], cfg, "cpu", torch.float32).set_attention_mode("sageattn_2")
    with torch.inference_mode():
        _int8_bound(model(inp["vid"], inp["txt"], inp["t"], plans).numpy(), ref, ref_k3)


# --------------------------------------------------------------------------- #
# K3s rank by rank (no collective inside: each rank's call stands alone)
# --------------------------------------------------------------------------- #


def _window_inputs(seed, nW, H=4, S=24, Lt=5, D=128):
    rs = np.random.RandomState(seed)
    vqkv = rs.randn(B, 3, H, nW, S, D).astype(np.float32)
    tqkv = rs.randn(B, 3, H, Lt, D).astype(np.float32)
    vang = rs.rand(nW, S, D).astype(np.float32) * 6
    tang = rs.rand(Lt, D).astype(np.float32) * 6
    valid = np.ones((nW, S), bool)
    valid[nW // 2, S * 2 // 3 :] = False  # a ragged window
    norms = (1 + 0.1 * rs.randn(4, D)).astype(np.float32)
    return vqkv, tqkv, vang, tang, valid, norms


def _k3s_assembled(inputs, seq, tensor, quant_qk=False):
    """Every (seq, tensor) rank's K3s output, placed as JAX's shard_map
    places its shards: [B, H, seq * per_rank, ...]."""
    vqkv, tqkv, vang, tang, valid, norms = (torch.from_numpy(x) for x in inputs)
    H = vqkv.shape[2]
    hl = H // tensor
    vid, txt = [], []
    for s in range(seq):
        heads_v, heads_t = [], []
        for t in range(tensor):
            hs = slice(t * hl, (t + 1) * hl)
            ov, ot = k3.fused_window_attention_sharded(
                vqkv[:, :, hs], tqkv[:, :, hs].contiguous(), vang.cos(), vang.sin(), tang.cos(), tang.sin(), valid,
                True, norms, True, 1e-5, quant_qk, seq_rank=s, seq_size=seq)
            heads_v.append(ov)
            heads_t.append(ot)
        vid.append(torch.cat(heads_v, 1))
        txt.append(torch.cat(heads_t, 1))
    return torch.cat(vid, 2).numpy(), torch.cat(txt, 2).numpy()


@pytest.mark.parametrize("nW,seq,tensor", [(3, 2, 1), (5, 2, 2), (4, 2, 2), (1, 2, 1), (3, 4, 1), (2, 4, 2)])
def test_k3s_matches_jax_sharded(nW, seq, tensor):
    """nW 3 and 5 on seq=2: the tail padded; nW 1 on 2 and 3 or 2 on 4: a
    rank with no window of its own launches one all-invalid window."""
    inputs = _window_inputs(nW * 10 + seq, nW)
    vqkv, tqkv, vang, tang, valid, norms = (jnp.asarray(x) for x in inputs)
    ref_v, ref_t = j_attn_sharded(vqkv, tqkv, vang, tang, valid, True, jmesh.make_mesh(1, seq, tensor), norms=norms,
                                  qk_norm=True, eps=1e-5, interpret=True)
    got_v, got_t = _k3s_assembled(inputs, seq, tensor)
    assert got_v.shape == ref_v.shape and got_t.shape == ref_t.shape
    np.testing.assert_allclose(got_v, np.asarray(ref_v), **TOL)
    np.testing.assert_allclose(got_t, np.asarray(ref_t), **TOL)


@pytest.mark.parametrize("nW,seq,tensor", [(3, 2, 2), (1, 2, 1)])
def test_k3s_int8_matches_jax_unsharded_k3q(nW, seq, tensor):
    """K3s with quant_qk: each rank's real windows against JAX's unsharded
    K3q (interpret mode) on the same windows and heads."""
    inputs = _window_inputs(nW + 7, nW)
    vqkv, tqkv, vang, tang, valid, norms = (jnp.asarray(x) for x in inputs)
    ref_v, ref_t = (np.asarray(r) for r in j_attn(vqkv, tqkv, vang, tang, valid, True, norms=norms, qk_norm=True,
                                                  eps=1e-5, interpret=True, quant_qk=True))
    got_v, got_t = _k3s_assembled(inputs, seq, tensor, quant_qk=True)
    np.testing.assert_allclose(got_v[:, :, :nW], ref_v, **TOL)
    np.testing.assert_allclose(got_t[:, :, :nW], ref_t, **TOL)


@pytest.mark.parametrize("nW,seq", [(18, 2), (75, 2), (3, 4), (1, 2), (7, 3)])
def test_window_range_covers_every_window_once(nW, seq):
    got = [k3.window_range(nW, seq, r) for r in range(seq)]
    per = got[0][2]
    assert all(p == per == max(1, -(-nW // seq)) for _, _, p in got)
    assert [w for first, end, _ in got for w in range(first, end)] == list(range(nW))


# --------------------------------------------------------------------------- #
# Mesh policy, coordinates, leaf split
# --------------------------------------------------------------------------- #


def test_auto_mesh_shape_equals_jax_over_a_grid():
    GB = 1 << 30
    for n in (1, 2, 3, 4, 6, 8, 16):
        for frames in (None, 1, 2, 3, 5, 6, 9, 16, 100):
            for heads in (0, 20, 24):
                for model, hbm in ((0, 0), (6.6, 16), (14.5, 16), (16.4, 80), (45, 80), (60, 24)):
                    args = (n, frames, heads, int(model * GB), int(hbm * GB))
                    assert mesh.auto_mesh_shape(*args) == jmesh.auto_mesh_shape(*args), args


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 2, 2), (4, 1, 2), (2, 3, 1), (1, 1, 4)])
def test_mesh_coordinates_follow_the_jax_device_order(shape):
    """Rank r sits where device r sits in JAX's reshape(data, seq, tensor);
    multihost feeds segment rank // (seq * tensor)."""
    n = int(np.prod(shape))
    for r in range(n):
        m = mesh.Mesh(dict(zip(mesh.AXES, shape)), r, {}, None, torch.device("cpu"))
        assert tuple(m.coords[a] for a in mesh.AXES) == tuple(np.unravel_index(r, shape))
        assert multihost.local_data_coords(m) == (r // (shape[1] * shape[2]), r // (shape[1] * shape[2]) + 1)


class _Shape:
    def __init__(self, shape):
        self.shape, self.ndim = shape, len(shape)


@pytest.mark.parametrize("factory,args", [("dit_tiny", ()), ("dit_tiny", ("window_pixel",)), ("dit_3b", ()),
                                          ("dit_7b", ())])
def test_leaf_spec_equals_jax(factory, args):
    """Every leaf of the port's NaDiT: qkv, out, mlp in/gate/out split as
    JAX's _dit_leaf_spec splits them, in vid, txt, shared and video-only
    layers; the rest replicated."""
    model = nadit.NaDiT(getattr(config, factory)(*args), "meta", torch.bfloat16)
    n_split = 0
    for path, m, leaf in leaf_paths(model):
        shape = tuple(getattr(m, leaf).shape)
        ours = sharding.leaf_spec(path, len(shape))
        assert ours == tuple(_dit_leaf_spec(path, _Shape(shape))), path
        n_split += "tensor" in ours
    assert n_split > 0


def test_local_slices_equal_the_jax_shards():
    """tensor=2: each rank's slice of every split leaf is JAX's shard on
    that rank's device; the column-parallel MLP bias (replicated in JAX,
    sliced at the add) follows its columns."""
    params = PARAMS["window_pixel"]  # the GELU MLP has the proj_in bias
    m = jmesh.make_mesh(1, 1, 2)
    shards = flatten_tree(shard_params(jax.tree.map(jnp.asarray, params), dit_param_shardings(params, m)))
    devices = list(m.devices.flat)
    cfg = config.dit_tiny("window_pixel")
    for path, full in flatten_tree(params).items():
        for shard in shards[path].addressable_shards:
            t = devices.index(shard.device)
            ours = sharding.local_slice(path, full, t, 2)
            if "/mlp/" in path and path.endswith("proj_in/b"):
                np.testing.assert_array_equal(ours, np.split(full, 2)[t])
            else:
                np.testing.assert_array_equal(ours, np.asarray(shard.data), err_msg=path)
    local = sharding.shard_flat(flatten_tree(params), cfg, 1, 2)
    assert local["blocks/0/attn/qkv/vid/w"].shape == (cfg.vid_dim, 3, cfg.inner_dim // 2)


@pytest.mark.parametrize("factory,tensor,ok", [("dit_tiny", 2, True), ("dit_tiny", 3, False), ("dit_3b", 4, True),
                                               ("dit_3b", 8, False), ("dit_7b", 8, True), ("dit_7b", 16, False)])
def test_heads_that_do_not_split_raise(factory, tensor, ok):
    """The JAX package runs K3 unsharded when heads % tensor != 0; the port
    refuses the split, at module build and at slicing."""
    cfg = getattr(config, factory)()
    if ok:
        assert nadit.NaDiT(cfg, "meta", torch.bfloat16, tensor=tensor).heads_local == cfg.heads // tensor
        return
    with pytest.raises(ValueError, match="heads"):
        nadit.NaDiT(cfg, "meta", torch.bfloat16, tensor=tensor)
    with pytest.raises(ValueError, match="heads"):
        sharding.shard_flat({}, cfg, 0, tensor)


def test_load_runner_needs_split_weights_on_a_tensor_mesh(tmp_path):
    """The split follows the mesh: on a tensor axis of 2, rank 1 loads the
    second half of every column-parallel weight (sliced on the host); an
    unsplittable axis raises like NaDiT, before any file is read."""
    from seedvr2_tpu_torch.pipeline.loader import load_runner

    _save_checkpoints(tmp_path)
    cfg = config.PipelineConfig(dit=config.dit_tiny(), vae=config.vae_tiny(), compute_dtype="float32")
    whole = dit_from_jax(PARAMS["mmrope3d"], cfg.dit, "cpu", torch.float32)
    for t, r in ((1, 0), (2, 1)):
        m = mesh.Mesh({"data": 1, "seq": 1, "tensor": t}, r, {}, None, torch.device("cpu"))
        dit = load_runner("tiny_dit.safetensors", "tiny_vae.safetensors", str(tmp_path), cfg, mesh=m).dit
        assert dit.tensor == t and dit.heads_local == cfg.dit.heads // t
        w, part = whole.blocks[0].attn.qkv["vid"].w, dit.blocks[0].attn.qkv["vid"].w
        n = w.shape[2] // t
        torch.testing.assert_close(part, w[:, :, r * n : (r + 1) * n], rtol=0, atol=0)
    m = mesh.Mesh({"data": 1, "seq": 1, "tensor": 3}, 0, {}, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="heads"):
        load_runner("tiny_dit.safetensors", "tiny_vae.safetensors", str(tmp_path), cfg, mesh=m)


def test_split_weights_need_the_matching_tensor_axis():
    cfg = config.dit_tiny()
    model = nadit.NaDiT(cfg, "cpu", torch.float32, tensor=2)
    plans = nadit.device_plans(nadit.build_attn_plans(cfg, (1, 4, 6), LT), cfg.head_dim, "cpu")
    inp = {k: torch.from_numpy(v) for k, v in INPUTS["b"].items()}
    with pytest.raises(RuntimeError, match="tensor"):
        model(inp["vid"], inp["txt"], inp["t"], plans)


@pytest.mark.parametrize("factory,jfactory", [(config.dit_tiny, j_dit_tiny), (config.dit_3b, j_dit_3b),
                                              (config.dit_7b, j_dit_7b)])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_dit_param_bytes_equal_jax(factory, jfactory, quantize):
    assert dit_param_bytes(factory(), quantize) == j_dit_param_bytes(jfactory(), quantize)


def test_no_mesh_on_one_rank_and_initialize_needs_torchrun(monkeypatch):
    assert mesh.build_mesh("auto", 10, config.dit_3b()) is None
    assert mesh.build_mesh("1,1,1", 10, config.dit_3b()) is None
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        multihost.initialize("gloo")


def test_initialize_from_a_torchrun_environment():
    """RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT as torchrun sets them
    (a port taken by binding to port 0), one gloo rank, in a fresh
    interpreter: the global data mesh and the segment this rank feeds."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    code = ("from seedvr2_tpu_torch.parallel import multihost as m; print(m.initialize('gloo')); "
            "g = m.global_data_mesh(device='cpu'); print(g.shape, m.local_data_coords(g))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.dirname(__file__)), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[:2] == ["(0, 1)", "{'data': 1, 'seq': 1, 'tensor': 1} (0, 1)"]


# --------------------------------------------------------------------------- #
# The launcher
# --------------------------------------------------------------------------- #


def _dead(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("task,deadline,message", [("raise", 60, "rank 1 raises on purpose"),
                                                   ("hang", 4, "still running")])
def test_launch_ends_every_rank_when_one_fails_or_hangs(tmp_path, task, deadline, message):
    t0 = time.monotonic()
    proc = ranks.start(task, tmp_path, 2, deadline)
    with pytest.raises(RuntimeError, match=message):
        ranks.finish(proc, tmp_path, 2, timeout=120)
    assert time.monotonic() - t0 < deadline + 60
    # every rank that got as far as writing its pid is gone (under load a
    # rank may still be starting when a short deadline passes)
    pids = [int(p.read_text()) for p in tmp_path.glob("pid_*")]
    assert len(pids) == 2 or task == "hang"
    assert all(_dead(p) for p in pids), pids


def test_port_cfg_of_the_cases_is_the_jax_one():
    for rope in ("mmrope3d", "window_pixel"):
        assert dataclasses.asdict(config.dit_tiny(rope)) == dataclasses.asdict(j_dit_tiny(rope))
