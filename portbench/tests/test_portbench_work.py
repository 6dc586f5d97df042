"""work.py's operations and bytes against counts made by hand."""

import pytest

from portbench import work


@pytest.mark.parametrize("x, kernel, cout, stride, pad, t_ext, flops, nbytes", [
    # 3x3x3, 128 -> 128, 5 frames extended to 7, 16 x 16 padded by 1: 5 x 16 x 16 outputs
    ((1, 5, 16, 16, 128), (3, 3, 3), 128, (1, 1, 1), ((1, 1), (1, 1)), 7,
     2 * (5 * 16 * 16 * 128) * 128 * 27, 2 * (5 * 16 * 16 * 128 + 27 * 128 * 128 + 5 * 16 * 16 * 128)),
    # the encoder's time-and-space downsampler: 3x3x3 stride 2, pad bottom/right, 5 frames extended to 7
    ((1, 5, 16, 16, 256), (3, 3, 3), 256, (2, 2, 2), ((0, 1), (0, 1)), 7,
     2 * (3 * 8 * 8 * 256) * 256 * 27, 2 * (5 * 16 * 16 * 256 + 27 * 256 * 256 + 3 * 8 * 8 * 256)),
])
def test_conv_counts(x, kernel, cout, stride, pad, t_ext, flops, nbytes):
    w = work.conv3d(x, kernel, cout, stride, pad, t_ext)
    assert w.flops == flops
    assert w.bytes == nbytes


def test_upsample_counts():
    # time upsample of 2 latent frames (16 x 16, C 8) on a first slice: 3 output frames taking 1, 2, 2 time taps
    w = work.upsample((1, 2, 16, 16, 8), temporal_up=True)
    assert w.flops == 2 * (1 + 2 + 2) * (32 * 32) * 8 * 8 * 4
    assert w.bytes == 2 * (2 * 16 * 16 * 8 + (27 + 8) * 64 + 3 * 32 * 32 * 8)
    # space only: every output frame takes 3 time taps
    w = work.upsample((1, 1, 16, 16, 8), temporal_up=False)
    assert w.flops == 2 * 3 * (32 * 32) * 8 * 8 * 4


@pytest.mark.parametrize("thw, shifted, lengths", [
    # 720p latent patched: 45 x 80, windows of 15 x 27 (the last column 26 wide)
    ((1, 45, 80), False, [15 * 27] * 3 + [15 * 27] * 3 + [15 * 26] * 3),
    # shifted: cuts at 7, 22, 37, 45 rows and 13, 40, 67, 80 columns
    ((1, 45, 80), True, [a * b for b in (13, 27, 27, 13) for a in (7, 15, 15, 8)]),
])
def test_window_lengths(thw, shifted, lengths):
    assert sorted(work.window_lengths(thw, (4, 3, 3), shifted)) == sorted(lengths)


def test_attention_counts():
    dit = {"heads": 2, "head_dim": 4, "window": (4, 3, 3)}
    # one window (the whole 1 x 2 x 3 latent) plus 5 text tokens: s = 11
    w = work.window_attention(dit, (1, 2, 3), 5, 1, False)
    assert w.flops == 4 * 11 * 11 * 8
    assert w.bytes == 2 * 4 * (6 + 5) * 8


def test_least_time_takes_the_larger_bound():
    w = work.Work(flops=989e12, bytes=3.35e12 * 2)
    assert w.least_s() == pytest.approx(2.0)
