"""The VAE's mid attention (seedvr2_tpu_torch/ops/mid_attention.py) on the
CPU: its plain version, through MidAttention, against the JAX package's
_mid_attention; and K10's tile walk (csrc/mid_attention.cuh) emulated in
numpy float32 against the plain version: 64-row query tiles (rows past n
computed on zeros and dropped), key tiles of the kernel's width with the
tail past n at -inf (out of the max and the denominator), the online max
and sum in the log2 domain, S as the sum of the two consumers' partials
over the halves of C, O in two column halves, 1 / denominator at the end.
The emulation is the kernel's algorithm, not its bf16 rounding of the
probabilities (fp32 here, as the plain version on fp32 inputs).

Tolerances: the emulation atol=2e-4, rtol=1e-3 (as tests/test_torch_flash_tiles.py
holds K5's walk: fp32 products summed in other orders); against JAX in fp32
atol=rtol=1e-4 (the same math op for op, BLAS and XLA summing in their own
orders); in bf16 relative L2 1e-2 (both round q, k, v, P and the output to
bf16, ~4e-3, at places their matmuls order differently).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.config import VAEConfig as JVAEConfig
from seedvr2_tpu.models.vae import model as jmodel
from seedvr2_tpu_torch.config import VAEConfig
from seedvr2_tpu_torch.models.vae import model as tmodel
from seedvr2_tpu_torch.ops import mid_attention as k10

F32 = np.float32
LOG2E = F32(1.4426950408889634)
EMU_TOL = dict(atol=2e-4, rtol=1e-3)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
# ragged pixel counts as (H, W): one pixel, a query tile less one, one more than a tile, a large prime-ish frame
FRAMES = {1: (1, 1), 63: (7, 9), 65: (5, 13), 4097: (17, 241)}


KEY_TILE = 32  # the kernel's keys a tile at every width (midattn::kBN in csrc/mid_attention.cuh)


def test_key_tile_is_the_kernels():
    header = (Path(k10.__file__).parent.parent / "csrc" / "mid_attention.cuh").read_text()
    assert f"constexpr int kBN = {KEY_TILE};" in header


def emulate_k10(q, k, v, bn):
    """[F, n, C] fp32 in, out: K10's walk over every frame."""
    F, n, C = q.shape
    half = C // 2
    rows = -(-n // 64) * 64
    scale_l2 = F32(1.0 / np.sqrt(C)) * LOG2E
    out = np.zeros_like(q)
    for f in range(F):
        Q = np.zeros((rows, C), F32)
        Q[:n] = q[f]
        m = np.full(rows, -np.inf, F32)
        lsum = np.zeros(rows, F32)
        o = [np.zeros((rows, half), F32) for _ in range(2)]
        for j in range(-(-n // bn)):
            keys = np.arange(j * bn, (j + 1) * bn)
            inside = keys < n
            K = np.zeros((bn, C), F32)
            V = np.zeros((bn, C), F32)
            K[inside], V[inside] = k[f, keys[inside]], v[f, keys[inside]]
            partial = [Q[:, g * half:(g + 1) * half] @ K[:, g * half:(g + 1) * half].T for g in (0, 1)]
            s = ((partial[0] + partial[1]) * scale_l2).astype(F32)
            s[:, ~inside] = -np.inf
            mx = np.maximum(m, s.max(1))
            alpha = np.exp2(m - mx).astype(F32)  # 0 at the first tile
            p = np.exp2(s - mx[:, None]).astype(F32)
            m = mx
            lsum = (lsum * alpha + p.sum(1)).astype(F32)
            for g in (0, 1):
                o[g] = (o[g] * alpha[:, None] + p @ V[:, g * half:(g + 1) * half]).astype(F32)
        out[f] = (np.concatenate(o, 1) / lsum[:, None])[:n]
    return out


def _qkv(F, n, C, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(F, n, C).astype(F32) for _ in range(3)]


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 200, 4097])
@pytest.mark.parametrize("C", [16, 64, 256, 512])
def test_k10_tile_walk_matches_the_plain_version(C, n):
    F = 1 if n > 1000 else 2
    q, k, v = _qkv(F, n, C, n + C)
    want = k10.mid_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    got = emulate_k10(q, k, v, KEY_TILE)
    np.testing.assert_allclose(got, want, **EMU_TOL)


def test_the_masked_key_tail_counts_no_key_twice():
    """Why the kernel masks the last tile's tail: its zero keys would each add
    exp(0 - max) to the denominator and drag every row towards 0."""
    q, k, v = _qkv(1, 65, 64, 3)
    full = emulate_k10(q, k, v, KEY_TILE)
    zeros = np.zeros((1, -65 % KEY_TILE, 64), F32)  # the last tile's keys past n
    q_pad, k_pad, v_pad = (np.concatenate([t, zeros], 1) for t in (q, k, v))
    unmasked = k10.mid_attention_plain(*map(torch.from_numpy, (q_pad, k_pad, v_pad))).numpy()[:, :65]
    assert not np.allclose(unmasked, full, **EMU_TOL)


def _mid_pair(C, groups, dtype, seed):
    """The JAX mid attention's parameters (every leaf perturbed) and the
    port's MidAttention holding the same values."""
    rs = np.random.RandomState(seed)
    p = {"group_norm": {"w": 1 + 0.2 * rs.randn(C), "b": 0.1 * rs.randn(C)}}
    for name in ("to_q", "to_k", "to_v", "to_out"):
        p[name] = {"w": rs.randn(C, C) / np.sqrt(C), "b": 0.1 * rs.randn(C)}
    p = jax.tree.map(lambda a: np.asarray(a, F32), p)
    mod = tmodel.MidAttention(C, VAEConfig(norm_num_groups=groups), "cpu", dtype)
    for name, leaf in p.items():
        for key, arr in leaf.items():
            getattr(mod, name).set_jax(key, arr)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jdtype), p), mod


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", list(FRAMES))
@pytest.mark.parametrize("C", [16, 64])
def test_mid_attention_matches_jax(C, n, dtype):
    """The plain version inside MidAttention (group norm, projections, the
    attention of every frame, out projection, residual) against JAX's
    _mid_attention, two frames."""
    H, W = FRAMES[n]
    groups = 4 if C == 16 else 32
    jp, mod = _mid_pair(C, groups, dtype, seed=C + n)
    x = np.random.RandomState(n).randn(1, 2, H, W, C).astype(F32)
    jx = jnp.asarray(x).astype(jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    ref = np.asarray(jmodel._mid_attention(jp, JVAEConfig(norm_num_groups=groups), jx).astype(jnp.float32))
    got = mod(torch.from_numpy(x).to(dtype)).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, **JAX_TOL)
    else:
        assert np.linalg.norm(got - ref) <= 1e-2 * np.linalg.norm(ref)


def test_mid_attention_runs_every_frame_in_one_call(monkeypatch):
    """MidAttention.forward hands the projections of all B * T frames to
    ops/mid_attention.py once, and adds to_out of its result to x: nothing
    between the projections and to_out but that call."""
    C, groups = 64, 32
    _, mod = _mid_pair(C, groups, torch.float32, seed=5)
    calls = []

    def spy(q, k, v):
        calls.append((q.shape, k.shape, v.shape))
        return k10.mid_attention_plain(q, k, v)

    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 5, 7, C).astype(F32))
    want = mod(x)
    monkeypatch.setattr(tmodel, "mid_attention", spy)
    got = mod(x)
    assert calls == [((6, 35, C),) * 3]
    assert torch.equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(2, 9, 16, 7))
    n0 = k10.mid_attention.launches
    assert torch.equal(k10.mid_attention(q, k, v), k10.mid_attention_plain(q, k, v))
    assert k10.mid_attention.launches == n0
