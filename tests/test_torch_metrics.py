"""The port's quality metrics (seedvr2_tpu_torch/utils/metrics.py) against
the JAX package's (seedvr2_tpu/utils/metrics.py): the same numpy code, so
every value must be equal (tolerance 0)."""

import numpy as np
import pytest

from seedvr2_tpu.utils import metrics as jmetrics
from seedvr2_tpu_torch.utils import metrics


def _pair(seed, shape, noise):
    rs = np.random.RandomState(seed)
    a = rs.rand(*shape).astype(np.float32)
    return a, np.clip(a + rs.randn(*shape).astype(np.float32) * noise, 0.0, 1.0)


@pytest.mark.parametrize("noise", [0.0, 1e-3, 0.05, 0.5])
def test_psnr_equal(noise):
    a, b = _pair(0, (3, 17, 23, 3), noise)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.psnr(a * 255, b * 255, 255.0) == jmetrics.psnr(a * 255, b * 255, 255.0)


@pytest.mark.parametrize("shape", [(24, 31, 3), (20, 16), (11, 11, 1)])
def test_ssim_equal(shape):
    a, b = _pair(1, shape, 0.1)
    got, ref = metrics.ssim(a, b), jmetrics.ssim(a, b)
    assert got == ref
    assert metrics.ssim(a, a) == jmetrics.ssim(a, a)


def test_video_psnr_ssim_equal():
    a, b = _pair(2, (4, 16, 20, 3), 0.02)
    assert metrics.video_psnr_ssim(a, b) == jmetrics.video_psnr_ssim(a, b)
