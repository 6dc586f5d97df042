"""The attention modes of the port vs the JAX package, on the same numpy
inputs in fp32:

- K3q: the plain version of fused_window_attention(quant_qk=True) vs the
  Pallas kernel in interpret mode;
- K5: the plain version of flash_attention vs the Pallas kernel in
  interpret mode (S not a multiple of 128, a masked key tail, q_valid, a
  batch row whose keys are all masked);
- attention_xla, and the alias table of attention_mode names.

Tolerance atol=2e-4, rtol=1e-3, as the JAX package's own kernel tests: both
sides accumulate fp32 products in different orders. K3q's int8 codes are
computed with the same fp32 operations in the same order on both sides, so
its bound is the same; the tests assert that the codes themselves agree.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvr2_tpu.ops import attention as jattention
from seedvr2_tpu.ops.flash_attention import flash_attention as j_flash
from seedvr2_tpu.ops.fused_window_attention import fused_window_attention as j_attn
from seedvr2_tpu_torch.ops import attention, flash_attention, fused_window_attention

TOL = dict(atol=2e-4, rtol=1e-3)
REPO = Path(__file__).resolve().parent.parent


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("rope_txt", [True, False])
def test_window_attention_int8_plain_matches_pallas(rope_txt):
    B, H, nW, S, Lt, D = 1, 2, 3, 24, 5, 128
    vqkv, tqkv = _rand((B, 3, H, nW, S, D), 20), _rand((B, 3, H, Lt, D), 21)
    vang = np.random.RandomState(22).rand(nW, S, D).astype(np.float32) * 6
    tang = np.random.RandomState(23).rand(Lt, D).astype(np.float32) * 6 if rope_txt else np.zeros((Lt, D), np.float32)
    valid = np.ones((nW, S), bool)
    valid[1, 17:] = False  # ragged windows
    valid[2, 9:] = False
    norms = 1 + _rand((4, D), 24, 0.1)
    ref_v, ref_t = j_attn(
        jnp.asarray(vqkv), jnp.asarray(tqkv), jnp.asarray(vang), jnp.asarray(tang), jnp.asarray(valid),
        rope_txt, norms=jnp.asarray(norms), qk_norm=True, eps=1e-5, interpret=True, quant_qk=True,
    )
    t = torch.from_numpy
    args = (t(vqkv), t(tqkv), t(vang).cos(), t(vang).sin(), t(tang).cos(), t(tang).sin(), t(valid), rope_txt, t(norms), True, 1e-5)
    got_v, got_t = fused_window_attention.fused_window_attention(*args, quant_qk=True)
    assert fused_window_attention.fused_window_attention.launches_int8 == 0  # a CPU tensor never reaches the kernel
    mask = np.broadcast_to(valid[None, None, :, :, None], got_v.shape)
    np.testing.assert_allclose(got_v.numpy()[mask], np.asarray(ref_v)[mask], **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), **TOL)
    # the int8 logits are not the bf16 ones: the quantisation is really on
    plain_v, _ = fused_window_attention.fused_window_attention(*args)
    assert np.abs(plain_v.numpy()[mask] - got_v.numpy()[mask]).max() > 1e-4


def test_quantize_rows_matches_the_pallas_rounding():
    """Per-row scale max|x| * (1/127) + 1e-8 and round-half-even codes, the
    JAX op order; includes rows built to land exactly on .5 ties."""
    x = _rand((6, 128), 25)
    x[3] = np.arange(128, dtype=np.float32) - 64.0  # max 64: x / s crosses many .5 points
    x[4] = 0.0
    x[5, :2] = (127.0, 0.5)
    codes, s = fused_window_attention.quantize_rows(torch.from_numpy(x))
    xj = jnp.asarray(x)
    sj = jnp.max(jnp.abs(xj), axis=-1, keepdims=True) * (1.0 / 127.0) + 1e-8
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jnp.round(xj / sj).astype(jnp.int8)).astype(np.float32))
    assert np.abs(codes.numpy()).max() <= 127


def _flash_inputs(B, S, H, D, seed):
    q, k, v = (_rand((B, S, H, D), seed + i) for i in range(3))
    kv_valid = np.ones((B, S), bool)
    kv_valid[0, S * 4 // 5 :] = False  # a masked key tail
    kv_valid[-1] = False  # a batch row with no valid key
    q_valid = np.ones((B, S), bool)
    q_valid[1, S * 2 // 3 :] = False
    return q, k, v, kv_valid, q_valid


@pytest.mark.parametrize("S", [150, 47])
@pytest.mark.parametrize("with_q_valid", [False, True])
def test_flash_attention_plain_matches_pallas(S, with_q_valid):
    """S = 150 pads to 256 keys in the JAX function, S = 47 to 128."""
    q, k, v, kv_valid, q_valid = _flash_inputs(3, S, 2, 128, 30)
    qv = q_valid if with_q_valid else None
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), kv_valid=jnp.asarray(kv_valid),
                             q_valid=None if qv is None else jnp.asarray(qv), interpret=True))
    t = torch.from_numpy
    got = flash_attention.flash_attention(t(q), t(k), t(v), t(kv_valid), None if qv is None else t(qv))
    assert flash_attention.flash_attention.launches == 0
    assert got.shape == ref.shape and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    if with_q_valid:
        assert not got.numpy()[1, S * 2 // 3 :].any()


def test_flash_attention_without_masks_matches_pallas():
    q, k, v, _, _ = _flash_inputs(2, 64, 3, 128, 40)
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), interpret=True))
    got = flash_attention.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_attention_xla_matches_jax():
    q, k, v, kv_valid, _ = _flash_inputs(3, 37, 2, 32, 50)
    ref = np.asarray(jattention.attention_xla(*map(jnp.asarray, (q, k, v)), kv_valid=jnp.asarray(kv_valid)))
    got = attention.attention_xla(*map(torch.from_numpy, (q, k, v)), kv_valid=torch.from_numpy(kv_valid))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    ref = np.asarray(jattention.attention_xla(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(attention.attention_xla(*map(torch.from_numpy, (q, k, v))).numpy(), ref, **TOL)


def test_attention_xla_q_valid_zeroes_rows():
    q, k, v, kv_valid, q_valid = _flash_inputs(3, 110, 2, 32, 60)
    t = torch.from_numpy
    full = attention.attention_xla(t(q), t(k), t(v), t(kv_valid))
    got = attention.attention_xla(t(q), t(k), t(v), t(kv_valid), t(q_valid))
    np.testing.assert_array_equal(got.numpy(), full.numpy() * q_valid[:, :, None, None])


def _jax_alias_table():
    """The dict literal of seedvr2_tpu/ops/attention.py:set_attention_backend."""
    tree = ast.parse((REPO / "seedvr2_tpu" / "ops" / "attention.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "set_attention_backend")
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign) and n.targets[0].id == "alias")
    return ast.literal_eval(node.value)


def test_alias_table_equals_the_jax_one():
    assert attention.ATTENTION_ALIASES == _jax_alias_table()


@pytest.mark.parametrize(
    "name", ["sdpa", "xla", "flash_attn_2", "flash_attn_3", "sageattn_2", "sageattn_3", "fused_int8", "pallas", "fused",
             "flash", "sageattn", "SDPA", ""],
)
def test_attention_mode_resolves_as_in_jax(name):
    prev = jattention.get_attention_backend()
    try:
        try:
            jattention.set_attention_backend(name)
            ref = jattention.get_attention_backend()
        except ValueError:
            ref = None
    finally:
        jattention.set_attention_backend(prev)
    if ref is None:
        with pytest.raises(ValueError, match="Unknown attention backend"):
            attention.resolve_attention_mode(name)
    else:
        assert attention.resolve_attention_mode(name) == ref


def test_attention_dispatch():
    q, k, v, kv_valid, _ = _flash_inputs(3, 40, 2, 32, 70)
    t = torch.from_numpy
    for backend, fn in (("pallas", flash_attention.flash_attention_plain), ("xla", attention.attention_xla),
                        ("fused", attention.attention_xla)):
        np.testing.assert_array_equal(
            attention.attention(t(q), t(k), t(v), t(kv_valid), backend=backend).numpy(),
            fn(t(q), t(k), t(v), t(kv_valid)).numpy(),
        )
