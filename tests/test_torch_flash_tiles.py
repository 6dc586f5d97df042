"""K5's tile walk (csrc/flash_attention.cuh on csrc/attention_pipeline.cuh)
emulated in numpy float32 against the JAX package's flash_attention (Pallas,
interpret mode), on the CPU: 64-key tiles, key codes from kv_valid (0, the
masked logit -1e30 in the log2 domain, -inf past S), the running max
starting at the masked logit, the padding keys' n_pad terms added to the
denominator at the end, q_valid rows zeroed, and the kernel's rule for
skipping a tile whose 64 keys are all masked: only in a batch row that has
a valid key. The emulation is the kernel's algorithm (not its bf16
rounding of the probabilities: v is fp32 here, as in the JAX function on
the CPU).

Tolerance atol=2e-4, rtol=1e-3, as tests/test_torch_attention.py holds K5's
plain version: fp32 products summed in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from seedvr2_tpu.ops.flash_attention import flash_attention as j_flash
from seedvr2_tpu_torch.ops.flash_attention import padded_len

TOL = dict(atol=2e-4, rtol=1e-3)
F32 = np.float32
LOG2E = F32(1.4426950408889634)
MASKED = F32(-1e30) * LOG2E


def live_tiles(kv_valid_row: np.ndarray) -> list:
    """The key tiles the kernel walks for one batch row (FlashTiles::live_tiles)."""
    S = kv_valid_row.shape[0]
    nk = -(-S // 64)
    live = [j for j in range(nk) if kv_valid_row[64 * j : 64 * j + 64].any()]
    return live if live and nk <= 64 else list(range(nk))


def emulate_k5(q, k, v, kv_valid, q_valid=None, skip=True, walk=None):
    """[B, S, H, D] fp32 in, out; (output, tiles skipped). ``walk(b)``, when
    given, replaces the kernel's list of tiles of batch row b."""
    B, S, H, D = q.shape
    nk = -(-S // 64)
    out = np.zeros_like(q)
    skipped = 0
    scale_l2 = F32(1.0 / np.sqrt(D)) * LOG2E
    for b in range(B):
        tiles = walk(b) if walk else live_tiles(kv_valid[b]) if skip else list(range(nk))
        skipped += nk - len(tiles)
        qb = q[b].transpose(1, 0, 2)  # [H, S, D]
        m = np.full((H, S), MASKED, F32)
        lsum = np.zeros((H, S), F32)
        o = np.zeros((H, S, D), F32)
        for j in tiles:
            keys = np.arange(64 * j, 64 * j + 64)
            inside = keys < S
            kk = np.zeros((64, H, D), F32)
            vv = np.zeros((64, H, D), F32)
            kk[inside], vv[inside] = k[b, keys[inside]], v[b, keys[inside]]
            code = np.where(~inside, F32(-np.inf), np.where(kv_valid[b, np.minimum(keys, S - 1)], F32(0), MASKED))
            s = np.einsum("hqd,khd->hqk", qb, kk).astype(F32) * scale_l2
            s = np.where(code != 0, code, s).astype(F32)
            mx = np.maximum(m, s.max(-1))
            alpha = np.exp2(m - mx).astype(F32)
            p = np.exp2(s - mx[..., None]).astype(F32)
            m = mx
            lsum = (lsum * alpha + p.sum(-1)).astype(F32)
            o = (o * alpha[..., None] + np.einsum("hqk,khd->hqd", p, vv)).astype(F32)
        den = (lsum + F32(padded_len(S) - S) * np.exp2(MASKED - m)).astype(F32)
        den = np.where(den == 0, F32(1), den)
        out[b] = (o / den[..., None]).transpose(1, 0, 2)
    if q_valid is not None:
        out = out * q_valid[:, :, None, None]
    return out, skipped


def _inputs(B, S, H, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, S, H, 128).astype(F32) for _ in range(3))
    return q, k, v


# (S, masked key ranges of batch row 0, batch row 1): row 2 has no valid key in every case
CASES = {
    "valid keys behind a masked tile": (150, [(0, 64)], [(100, 150)]),
    "the last tiles masked": (200, [(128, 200)], [(64, 128)]),
    "one tile, a masked tail": (37, [(30, 37)], []),
    "a masked tile between valid ones": (463, [(64, 192), (400, 463)], [(0, 5)]),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("q_pattern", [None, "strided"])
def test_k5_tile_walk_matches_pallas(case, q_pattern):
    S, row0, row1 = CASES[case]
    q, k, v = _inputs(3, S, 2, 11)
    kv_valid = np.ones((3, S), bool)
    for row, ranges in ((0, row0), (1, row1)):
        for lo, hi in ranges:
            kv_valid[row, lo:hi] = False
    kv_valid[2] = False
    q_valid = None
    if q_pattern:
        q_valid = np.ones((3, S), bool)
        q_valid[:, 1::3] = False
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), kv_valid=jnp.asarray(kv_valid),
                             q_valid=None if q_valid is None else jnp.asarray(q_valid), interpret=True))
    got, skipped = emulate_k5(q, k, v, kv_valid, q_valid)
    np.testing.assert_allclose(got, ref, **TOL)
    # a skipped tile changes no bit of a row that has a valid key
    full, none_skipped = emulate_k5(q, k, v, kv_valid, q_valid, skip=False)
    assert none_skipped == 0 and np.array_equal(got[:2], full[:2])
    assert skipped == sum(-(-S // 64) - len(live_tiles(kv_valid[b])) for b in range(2))
    if S > 64 and case != "one tile, a masked tail":
        assert skipped > 0
    # no valid key: every masked key counts, none is skipped, sum(v) / Sp
    assert live_tiles(kv_valid[2]) == list(range(-(-S // 64)))
    want = v[2].sum(0) / padded_len(S)
    rows = slice(None) if q_valid is None else q_valid[2]
    np.testing.assert_allclose(got[2][rows], np.broadcast_to(want, got[2].shape)[rows], **TOL)


def test_k5_skipping_all_masked_keys_would_be_wrong():
    """Why a row with no valid key skips nothing: its masked keys are the
    whole result, sum(v) / Sp, so leaving out its all-masked tiles (as a
    row with a valid key may) drops their values."""
    S = 150
    q, k, v = _inputs(1, S, 2, 12)
    kv_valid = np.zeros((1, S), bool)
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), kv_valid=jnp.asarray(kv_valid), interpret=True))
    got, skipped = emulate_k5(q, k, v, kv_valid)
    assert skipped == 0
    np.testing.assert_allclose(got, ref, **TOL)
    dropped, _ = emulate_k5(q, k, v, kv_valid, walk=lambda b: [0])
    assert not np.allclose(dropped, ref, **TOL)
