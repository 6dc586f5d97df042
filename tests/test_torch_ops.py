"""seedvr2_tpu_torch plain ops vs the JAX package on the same numpy inputs.

Tolerances: both sides compute in fp32 from identical inputs, so they differ
only by summation order (~1e-6 relative); atol=2e-5 / rtol=1e-5 unless a
test says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvr2_tpu.ops import color as jcolor
from seedvr2_tpu.ops import normalization as jnorm
from seedvr2_tpu.ops import resize as jresize
from seedvr2_tpu.ops import rope as jrope
from seedvr2_tpu.pipeline import diffusion as jdm
from seedvr2_tpu_torch.ops import color, normalization, resize, rope
from seedvr2_tpu_torch.pipeline import diffusion as dm

TOL = dict(atol=2e-5, rtol=1e-5)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm():
    x, w = _rand((3, 5, 64)), 1 + _rand((64,), 1, 0.1)
    np.testing.assert_allclose(
        normalization.rms_norm(_t(x), _t(w), 1e-5).numpy(), np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL
    )


@pytest.mark.parametrize("groups", [4, 32])
def test_group_norm(groups):
    x, w, b = _rand((2, 6, 5, 64), 2, 2.0) + 0.5, 1 + _rand((64,), 3, 0.1), _rand((64,), 4, 0.1)
    got = normalization.group_norm(_t(x), groups, _t(w), _t(b), eps=1e-6).numpy()
    ref = np.asarray(jnorm.group_norm(jnp.asarray(x), groups, jnp.asarray(w), jnp.asarray(b), eps=1e-6))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("dims,offsets", [((2, 3, 4), (58, 0, 0)), ((5,), None)])
def test_rope_tables(dims, offsets):
    np.testing.assert_array_equal(rope.axial_freqs_lang(dims, 42, offsets=offsets), jrope.axial_freqs_lang(dims, 42, offsets=offsets))
    np.testing.assert_array_equal(rope.axial_freqs_pixel(dims, 20), jrope.axial_freqs_pixel(dims, 20))
    a = rope.axial_freqs_lang(dims, 42).reshape(-1, 42 * len(dims))
    np.testing.assert_array_equal(rope.pad_angles(a, 128), jrope.pad_angles(a, 128))


@pytest.mark.parametrize("r", [126, 128])
def test_apply_rotary(r):
    x, ang = _rand((2, 7, 128), 5), _rand((7, r), 6, 3.0)
    got = rope.apply_rotary(_t(x), _t(ang)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrope.apply_rotary(jnp.asarray(x), jnp.asarray(ang))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("r", [60, 126, 128])
def test_apply_rotary_on_the_unfused_window_layout(r):
    """x [B, nW, mL, H, hd] with angles [1, nW, mL, 1, R], as the unfused
    window attention ropes q and k (R = 60: the 7B window_pixel width);
    rotate() with the zero-padded tables' cos/sin is the same rotation."""
    x, ang = _rand((2, 3, 5, 4, 128), 7), _rand((1, 3, 5, 1, r), 8, 3.0)
    ref = np.asarray(jrope.apply_rotary(jnp.asarray(x), jnp.asarray(ang)))
    np.testing.assert_allclose(rope.apply_rotary(_t(x), _t(ang)).numpy(), ref, atol=1e-5, rtol=1e-5)
    padded = _t(rope.pad_angles(ang, 128))
    np.testing.assert_allclose(rope.rotate(_t(x), padded.cos(), padded.sin()).numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw,res,mx", [((24, 20), 32, 0), ((36, 64), 20, 0), ((50, 30), 64, 80)])
def test_pipeline_transform(hw, res, mx):
    assert resize.side_resize_dims(*hw, res, mx) == jresize.side_resize_dims(*hw, res, mx)
    assert resize.true_target_dims(*hw, res, mx) == jresize.true_target_dims(*hw, res, mx)
    np.testing.assert_array_equal(resize.resample_matrix(hw[0], res), jresize.resample_matrix(hw[0], res))
    v = np.random.RandomState(7).rand(3, *hw, 3).astype(np.float32)
    got = resize.pipeline_transform(_t(v), res, mx).numpy()
    np.testing.assert_allclose(got, np.asarray(jresize.pipeline_transform(jnp.asarray(v), res, mx)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float16])
def test_to_f01(dtype):
    hi = {np.uint8: 255, np.uint16: 65535, np.float16: 1}[dtype]
    v = (np.random.RandomState(8).rand(2, 4, 5, 3) * hi).astype(dtype)
    host = v.astype(np.int32) if dtype == np.uint16 else v  # the port ships 16-bit codes as int32
    np.testing.assert_array_equal(resize.to_f01(_t(host)).numpy(), np.asarray(jresize.to_f01(jnp.asarray(v))))


@pytest.mark.parametrize("hw", [(40, 48), (8, 12)])
def test_wavelet_reconstruction(hw):
    c, s = np.tanh(_rand((2, 3, *hw), 9)), np.tanh(_rand((2, 3, *hw), 10))
    got = color.apply_color_correction("wavelet", _t(c), _t(s)).numpy()
    ref = np.asarray(jcolor.apply_color_correction("wavelet", jnp.asarray(c), jnp.asarray(s)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(color.apply_color_correction("none", _t(c), _t(s)).numpy(), c)


def test_color_methods_not_ported_raise():
    x = torch.zeros(1, 3, 8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        color.apply_color_correction("lab", x, x)


@pytest.mark.parametrize("pred_type", ["v_lerp", "x_0", "x_T", "v_cos"])
def test_euler_sample(pred_type):
    x = _rand((2, 3, 4, 5, 4), 11)
    pred = _rand((2, 3, 4, 5, 4), 12)
    ts = list(jdm.uniform_trailing_timesteps(2, 1000.0))
    np.testing.assert_array_equal(dm.uniform_trailing_timesteps(2, 1000.0), np.asarray(ts))
    f_j = lambda xt, t, i: xt * 0.5 + jnp.asarray(pred)
    f_t = lambda xt, t, i: xt * 0.5 + _t(pred)
    ref = np.asarray(jdm.euler_sample(jnp.asarray(x), f_j, ts, 1000.0, pred_type))
    got = dm.euler_sample(_t(x), f_t, ts, 1000.0, pred_type).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_timestep_transform_and_schedule():
    t = np.array([300.0, 700.0], np.float32)
    shapes = np.array([[2, 45, 80], [1, 64, 64]], np.int32)
    got = dm.timestep_transform(_t(t), _t(shapes)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdm.timestep_transform(jnp.asarray(t), jnp.asarray(shapes))), rtol=1e-6)
    x0, xT = _rand((2, 3, 4), 13), _rand((2, 3, 4), 14)
    np.testing.assert_allclose(
        dm.schedule_forward(_t(x0), _t(xT), _t(t), 1000.0).numpy(),
        np.asarray(jdm.schedule_forward(jnp.asarray(x0), jnp.asarray(xT), jnp.asarray(t), 1000.0)),
        **TOL,
    )


def test_cfg_dispatch():
    pos, neg = _rand((2, 3, 4), 15), _rand((2, 3, 4), 16)
    assert dm.cfg_dispatch(lambda: _t(pos), None, 1.0) is not None  # scale 1 skips the negative branch
    got = dm.cfg_dispatch(lambda: _t(pos), lambda: _t(neg), 3.0, 0.7).numpy()
    ref = np.asarray(jdm.cfg_dispatch(lambda: jnp.asarray(pos), lambda: jnp.asarray(neg), 3.0, 0.7))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
