"""The window's arithmetic and the trace's attribution, against hand counts."""

import pytest

from portbench import window
from portbench.trace import Trace


def test_rate_over_whole_requests():
    spans = [(10.0, 12.0), (12.0, 15.5), (15.5, 16.0)]
    lo, hi = window.window_bounds(spans)
    assert (lo, hi) == (10.0, 16.0)
    assert window.rate(3 * 25, hi - lo) == pytest.approx(12.5)


@pytest.mark.parametrize("n, q, expect", [
    (100, 90, 90), (10, 90, 9), (11, 90, 10), (1, 90, 1), (95, 90, 86)])
def test_nearest_rank(n, q, expect):
    values = list(range(n, 0, -1))  # n .. 1, unsorted on purpose
    assert window.nearest_rank(values, q) == expect


def test_union_of_overlapping_intervals():
    # [0, 4] and [2, 6] overlap (6), [8, 9] apart (1), [8.5, 8.7] inside it
    assert window.union_length([(2, 6), (0, 4), (8, 9), (8.5, 8.7)]) == 7
    assert window.gaps([(2, 6), (0, 4), (8, 9)], 0, 10) == [(6, 8), (9, 10)]


def _trace():
    ev = []

    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)

    x("user_annotation", "pb.attn", 0, 100)
    x("user_annotation", "pb.attn_proj", 5, 10)
    x("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1)  # the projection
    x("cuda_driver", "cuLaunchKernelEx", 20, 1, corr=2)  # attention, launched by cuLaunchKernelEx
    x("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=3)
    x("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=4)  # outside every range
    x("kernel", "gemm", 10, 40, corr=1)
    x("kernel", "flash", 40, 30, corr=2)  # overlaps the gemm by 10
    x("kernel", "gather", 100, 20, corr=3)
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 200, 50, tid=7, corr=4)
    return Trace(ev)


def test_trace_attribution():
    t = _trace()
    assert t.unlaunched == 0
    assert t.busy_s() == pytest.approx((60 + 20 + 50) / 1e6)  # [10, 70], [100, 120], [200, 250]
    assert t.spans("pb.attn") == [pytest.approx(110 / 1e6)]  # 10 .. 120
    assert t.busy("pb.attn") == pytest.approx(80 / 1e6)
    assert t.busy("pb.attn", exclude="pb.attn_proj") == pytest.approx(50 / 1e6)  # [40, 70] and [100, 120]
    assert t.copies_s("DtoH") == pytest.approx(50 / 1e6)
    assert t.top_ops(2)[0] == ["Memcpy DtoH (Device -> Pinned)", pytest.approx(50 / 1e6)]
    assert t.top_ops(5, "pb.attn", "pb.attn_proj") == [["flash", pytest.approx(30 / 1e6)],
                                                       ["gather", pytest.approx(20 / 1e6)]]


def test_idle_gaps_named_by_the_host():
    t = _trace()
    # gaps [70, 100] (inside pb.attn on the host) and [120, 200] (no host op open)
    by = dict(t.idle_by_host(10, 250))
    assert by["pb.attn"] == pytest.approx(30 / 1e6)
    assert by["host code outside any op"] == pytest.approx(80 / 1e6)
