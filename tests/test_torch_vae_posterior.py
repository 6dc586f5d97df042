"""The VAE posterior's draw (seedvr2_tpu_torch/models/vae/model.py:
posterior_sample) against seedvr2_tpu/models/vae/model.py:posterior_sample
on the same moments and the same standard normal noise (JAX's own draw
from its key, passed to the port as ``eps``), fp32 and bf16 moments, the
log-variance clipped at -30 and 20; and the port's own draw from a
torch.Generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu.models.vae.model import posterior_sample as j_posterior_sample
from seedvr2_tpu_torch.models.vae.model import posterior_mode, posterior_sample

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_posterior_sample_equals_jax(dtype):
    rs = np.random.RandomState(0)
    moments = rs.randn(1, 2, 3, 5, 8).astype(np.float32)
    # log-variances beyond both clips, at them, and inside
    moments[..., 4:] = rs.choice([-80.0, -30.0, -2.0, 0.0, 1.5, 20.0, 60.0], size=moments[..., 4:].shape)
    jm = jnp.asarray(moments, dtype)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, jm[..., :4].shape, jnp.float32))
    ref = np.asarray(j_posterior_sample(jm, key).astype(jnp.float32))
    tm = torch.from_numpy(np.array(jm.astype(jnp.float32))).to(TORCH_DTYPES[dtype])
    got = posterior_sample(tm, eps=torch.from_numpy(eps))
    assert got.dtype == tm.dtype and got.shape == (1, 2, 3, 5, 4)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-6, atol=0)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 1e3  # logvar 20: std e^10 reached, 60 clipped


def test_posterior_sample_draws_from_the_generator():
    moments = torch.zeros(2, 3, 6)
    moments[..., :3] = 1.0
    a = posterior_sample(moments, torch.Generator().manual_seed(5))
    b = posterior_sample(moments, torch.Generator().manual_seed(5))
    eps = torch.randn((2, 3, 3), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.equal(a, 1.0 + eps)  # logvar 0: std 1
    assert torch.equal(posterior_sample(moments, eps=torch.zeros(2, 3, 3)), posterior_mode(moments))
