"""K8, the GroupNorm statistics kernel of K4's route (csrc/gn_stats.cuh), on
the CPU: its chunk-and-merge order emulated in numpy float32 against the
JAX package's gn_silu_tables, and the CPU wrapper against its plain version.

The emulation follows the kernel step by step: a frame cut into chunks of
ppb * steps pixels (ops/conv3d_kernel.py:gn_stats_geometry, the kernel's
own numbers), C / 8 threads a pixel each holding (mean, M2) of its two
4-channel halves over its pixels, 4 pixels (16 values a half) reduced
two-pass and merged by Chan's formula, then 1-pixel batches for the rest;
each chunk's threads merged group by group in thread order; a frame's
chunks merged in 32 index-ordered lane ranges, then pairwise. The kernel
contracts some products into FMAs, so the emulation is its algorithm, not
its bits; the card tests hold the kernel itself against fp64.

Tolerance atol=rtol=1e-6, as tests/test_torch_conv_kernels.py holds the
plain tables: fp32 statistics in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.ops import conv3d_kernel as jck
from seedvr2_tpu_torch.ops import conv3d_kernel
from test_torch_conv_kernels import GN_SHAPES, _gn_inputs

TOL = dict(atol=1e-6, rtol=1e-6)
F32 = np.float32


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as fp32 (the kernel reads bf16)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _merge(n, mean, m2, nb, mb, m2b):
    """Chan's merge (gn_stats.cuh:merge) of (nb, mb, m2b) into (n, mean, m2),
    elementwise in float32; nb == 0 leaves the left side as it is."""
    nn = n + nb
    w = np.where(nb > 0, nb / np.where(nn > 0, nn, F32(1)), F32(0)).astype(F32)
    d = (mb - mean).astype(F32)
    new_mean = (mean + d * w).astype(F32)
    new_m2 = (m2 + m2b + d * d * (n * w)).astype(F32)
    take = nb > 0
    return np.where(take, nn, n).astype(F32), np.where(take, new_mean, mean), np.where(take, new_m2, m2)


def _batch(vals):
    """(mean, M2) of the last axis, two-pass, summed in order (gn_stats.cuh:batch)."""
    k = vals.shape[-1]
    s = np.zeros(vals.shape[:-1], F32)
    for i in range(k):
        s = (s + vals[..., i]).astype(F32)
    mean = (s * F32(1.0 / k)).astype(F32)
    m2 = np.zeros_like(s)
    for i in range(k):
        d = (vals[..., i] - mean).astype(F32)
        m2 = (m2 + d * d).astype(F32)
    return mean, m2


def emulate_k8(x: np.ndarray, gw: np.ndarray, gb: np.ndarray, groups: int, eps: float = 1e-6):
    """K8's tables of x [B, T, H, W, C] (fp32 holding bf16 values) in its order."""
    B, T, H, W, C = x.shape
    P, frames, cg = H * W, B * T, C // groups
    ppb, steps = conv3d_kernel.gn_stats_geometry(C)
    tpp, chunk = C // 8, ppb * steps
    chunks = -(-P // chunk)
    xs = x.reshape(frames, P, tpp, 2, 4).astype(F32)  # [frame, pixel, thread's 8 channels, half, 4]
    pad = np.zeros((frames, chunks * chunk - P, tpp, 2, 4), F32)
    xs = np.concatenate([xs, pad], 1).reshape(frames, chunks, steps, ppb, tpp, 2, 4)  # pixel k*chunk + s*ppb + pl
    px = np.arange(chunks * chunk).reshape(chunks, steps, ppb)
    n_valid = (px < P).sum(1)  # [chunks, ppb]: a thread's pixels, a prefix of its steps

    # threads: (frame, chunk, pixel lane, thread, half)
    shape = (frames, chunks, ppb, tpp, 2)
    n, mean, m2 = np.zeros(shape, F32), np.zeros(shape, F32), np.zeros(shape, F32)
    nv = n_valid[None, :, :, None, None]
    for b in range(steps // 4):
        vals = xs[:, :, 4 * b : 4 * b + 4].transpose(0, 1, 3, 4, 5, 2, 6).reshape(*shape, 16)
        bm, bm2 = _batch(vals)
        nb = np.where(nv >= 4 * b + 4, F32(16), F32(0))
        n, mean, m2 = _merge(n, mean, m2, nb, bm, bm2)
    for s in range(steps):  # the tail: single pixels past the last full batch of 4
        bm, bm2 = _batch(xs[:, :, s])
        nb = np.where((nv // 4 * 4 <= s) & (s < nv), F32(4), F32(0))
        n, mean, m2 = _merge(n, mean, m2, nb, bm, bm2)

    # the block: group g merges halves hh in [g * cg / 4, (g + 1) * cg / 4) of each pixel lane, in order
    hpg = cg // 4
    n = n.reshape(frames, chunks, ppb, 2 * tpp)
    mean = mean.reshape(frames, chunks, ppb, 2 * tpp)
    m2 = m2.reshape(frames, chunks, ppb, 2 * tpp)
    gshape = (frames, chunks, groups)
    cn, cm, cm2 = np.zeros(gshape, F32), np.zeros(gshape, F32), np.zeros(gshape, F32)
    hh0 = np.arange(groups) * hpg
    for pl in range(ppb):
        for o in range(hpg):
            hh = hh0 + o
            cn, cm, cm2 = _merge(cn, cm, cm2, n[:, :, pl, hh], mean[:, :, pl, hh], m2[:, :, pl, hh])

    # the tables kernel: lane l merges chunks [l * per, (l + 1) * per) in order, then pairwise
    counts = ((np.minimum(P, (np.arange(chunks) + 1) * chunk) - np.arange(chunks) * chunk) * cg).astype(F32)
    per = -(-chunks // 32)
    lshape = (frames, groups, 32)
    ln, lm, lm2 = np.zeros(lshape, F32), np.zeros(lshape, F32), np.zeros(lshape, F32)
    for i in range(per):
        k = np.arange(32) * per + i
        ok = k < chunks
        kk = np.minimum(k, chunks - 1)
        nb = np.where(ok, counts[kk], F32(0))[None, None, :]
        ln, lm, lm2 = _merge(ln, lm, lm2, np.broadcast_to(nb, lshape),
                             cm[:, kk].transpose(0, 2, 1), cm2[:, kk].transpose(0, 2, 1))
    s = 1
    while s < 32:
        lanes = np.arange(0, 32, 2 * s)
        a = _merge(ln[..., lanes], lm[..., lanes], lm2[..., lanes], ln[..., lanes + s], lm[..., lanes + s],
                   lm2[..., lanes + s])
        ln[..., lanes], lm[..., lanes], lm2[..., lanes] = a
        s *= 2
    tot_n, tot_mean, tot_m2 = ln[..., 0], lm[..., 0], lm2[..., 0]  # [frames, groups]
    var = (tot_m2 / tot_n).astype(F32)
    rstd = (F32(1) / np.sqrt((var + F32(eps)).astype(F32))).astype(F32)
    scale = (np.repeat(rstd, cg, axis=1) * gw.astype(F32)).astype(F32)
    shift = (gb.astype(F32) - np.repeat(tot_mean, cg, axis=1) * scale).astype(F32)
    return scale.reshape(B, T, C), shift.reshape(B, T, C)


def _check(x, gw, gb, groups):
    ref = jck.gn_silu_tables(jnp.asarray(x), jnp.asarray(gw), jnp.asarray(gb), groups)
    got = emulate_k8(x, gw, gb, groups)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)


@pytest.mark.parametrize("groups", [32, 4])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_k8_merge_order_matches_jax(shape, groups):
    """GN_SHAPES (every one has (C / groups) % 4 == 0 at both group counts),
    each frame far below one chunk."""
    x, _, _, gw, gb = _gn_inputs(shape, 0)
    _check(_bf16(x), gw, gb, groups)


def _max_rel(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("C,H,W", [(128, 40, 100), (256, 17, 70), (512, 9, 61)])
def test_k8_merge_order_with_an_offset_mean(C, H, W):
    """8 + N(0, 1) in bf16, where E[x^2] - E[x]^2 would lose ~8 bits:
    several chunks a frame (4000, 1190 and 549 pixels against chunks of
    1024, 512 and 256), the last one partial, a partial batch of 4 in it.
    Errors are max |got - ref| / max |ref| against fp64 tables. The JAX
    package's own fp32 tables are up to 1.1e-6 from fp64 here (XLA's
    reduction order: 1.09e-6 / 1.06e-6 at C = 512), so the emulation is held
    within 1e-6 of fp64, no further from it than JAX's tables, and within
    1e-6 plus JAX's own error of JAX's tables."""
    rs = np.random.RandomState(3)
    x = _bf16((8.0 + rs.randn(2, 2, H, W, C)).astype(F32))
    gw, gb = (1 + 0.2 * rs.randn(C)).astype(F32), (0.3 * rs.randn(C)).astype(F32)
    xd = x.astype(np.float64).reshape(2, 2, H * W, 32, C // 32)
    mean, var = xd.mean(axis=(2, 4)), xd.var(axis=(2, 4))
    scale = np.repeat(1 / np.sqrt(var + 1e-6), C // 32, axis=-1) * gw
    shift = gb - np.repeat(mean, C // 32, axis=-1) * scale
    jax_tables = jck.gn_silu_tables(jnp.asarray(x), jnp.asarray(gw), jnp.asarray(gb), 32)
    for got, ref, jref in zip(emulate_k8(x, gw, gb, 32), (scale, shift), jax_tables):
        err, jax_err = _max_rel(got, ref), _max_rel(jref, ref)
        assert err < 1e-6 and err <= jax_err
        assert _max_rel(got, np.asarray(jref, np.float64)) <= 1e-6 + jax_err


def test_k8_geometry_fills_whole_blocks():
    """The block is C / 8 threads a pixel times ppb pixels, at most 1024
    threads; at the VAE's widths a chunk is 256 KB of x."""
    for C in (8, 64, 128, 256, 384, 512, 2048, 8192):
        ppb, steps = conv3d_kernel.gn_stats_geometry(C)
        assert 1 <= ppb * (C // 8) <= 1024 and steps % 4 == 0
    for C in (128, 256, 512):
        ppb, steps = conv3d_kernel.gn_stats_geometry(C)
        assert ppb * steps * C * 2 == 256 * 1024 and ppb * (C // 8) == 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_silu_tables_on_the_cpu_is_the_plain_version(dtype):
    """The wrapper runs gn_silu_tables_plain on a CPU tensor, to the bit,
    and counts no launch."""
    x, _, _, gw, gb = _gn_inputs(GN_SHAPES[1], 5)
    t = torch.from_numpy
    n0 = conv3d_kernel.gn_silu_tables.launches
    got = conv3d_kernel.gn_silu_tables(t(x).to(dtype), t(gw), t(gb), 32)
    want = conv3d_kernel.gn_silu_tables_plain(t(x).to(dtype), t(gw), t(gb), 32)
    assert conv3d_kernel.gn_silu_tables.launches == n0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
