"""The kernel bench (seedvr2_tpu_torch/conv_ab.py) on the CPU, with fake
libraries in place of compiled trees: a tree that lacks a kernel's C entry
(an older tree, or one that renamed or split it) is bound without error and
left out of that kernel's rows, while the other builds still run.
"""

import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu_torch import conv_ab
from seedvr2_tpu_torch.ops import cuda_lib

ENTRY = "seedvr2_gn_apply"


class FakeLib:
    """Exports ``entries``: each doubles its argument and records the call."""

    def __init__(self, entries, calls):
        def entry(name):
            def call(x):
                calls.append(name)
                return x * 2

            return call

        self._entries = {e: entry(e) for e in entries}

    def __getattr__(self, name):
        try:
            return self.__dict__["_entries"][name]
        except KeyError:
            raise AttributeError(name) from None


def test_bind_types_only_the_entries_a_tree_exports():
    lacking = [e for e in cuda_lib._SIGNATURES if e != ENTRY]
    lib = conv_ab.bind(FakeLib(lacking, []))
    for e in lacking:
        assert getattr(lib, e).argtypes == cuda_lib._SIGNATURES[e]
        assert getattr(lib, e).restype is not None
    assert not hasattr(lib, ENTRY)


@pytest.mark.parametrize("entries", [(ENTRY,), (ENTRY, "seedvr2_mid_attention")])
def test_a_row_leaves_out_a_tree_without_its_entry(monkeypatch, entries, capsys):
    monkeypatch.setattr(conv_ab, "cuda_ms", lambda fn, reps=10: (fn(), 1.0)[1])
    calls = []
    every = list(cuda_lib._SIGNATURES)
    libs = {"this": FakeLib(every, calls), "old": FakeLib([e for e in every if e != entries[-1]], calls),
            "new": FakeLib([*every, "seedvr2_future"], calls)}
    b = conv_ab.Bench(libs, {}, 2, torch.device("cpu"))
    assert set(b.family(None, entries)) == {"this", "new"}
    assert set(b.family()) == {"this", "old", "new"}
    x = torch.randn(4, 8)
    row = b.row("K9 fake", lambda: x * 2, lambda L: getattr(L, ENTRY)(x), entries, x * 2, lambda: x * 2,
                x.numel() * 4, {}, path="720p", model="3b")
    assert row["kernel"] == "K9" and row["path"] == "720p" and row["model"] == "3b" and row["launches"] is None
    assert row["rel_l2"] == 0.0 and row["ms"] == 1.0 and row["library_ms"] is None
    assert row["share"] == row["bound_ms"] and b.rows == [row]
    assert f"(left out, no {'/'.join(entries)}: old)" in capsys.readouterr().out
    # the rel L2 of "new", this tree's launch against the wrapper, then each build timed in two rounds
    assert len(calls) == 1 + 1 + 2 * 2


def test_a_row_raises_when_the_bench_launch_is_not_the_wrappers(monkeypatch):
    monkeypatch.setattr(conv_ab, "cuda_ms", lambda fn, reps=10: 1.0)
    x = torch.randn(4, 8)
    b = conv_ab.Bench({"this": FakeLib([ENTRY], [])}, {}, 1, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="differs from the wrapper's"):
        b.row("K9 fake", lambda: x * 2 + 1e-3, lambda L: getattr(L, ENTRY)(x), (ENTRY,), x * 2, lambda: x * 2,
              x.numel() * 4, {})
