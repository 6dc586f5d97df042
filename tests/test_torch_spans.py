"""The port's profiler ranges (seedvr2_tpu_torch/utils/spans.py): which
ranges a ``phases.generate`` call leaves in an exported Chrome trace, and
how they nest; the VAE's ranges on each conv route; a span with no
profiler running; and the run log's quiet memory summary.

On the CPU with tiny configs (vae_tiny + dit_tiny, fp32, random weights):
the ranges are host ranges, the same on a card.
"""

import builtins
import dataclasses
import json
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch CPU thread a test process)

from seedvr2_tpu_torch import config
from seedvr2_tpu_torch.io.weights import random_dit, random_vae
from seedvr2_tpu_torch.models.vae.causal_conv import CausalConv3d, StreamCtx
from seedvr2_tpu_torch.models.vae.model import _norm
from seedvr2_tpu_torch.pipeline import phases
from seedvr2_tpu_torch.pipeline.runner import Runner
from seedvr2_tpu_torch.utils import debug, spans

PORT = Path(__file__).resolve().parents[1] / "seedvr2_tpu_torch"
STAGES = ("runner.transform", "runner.vae_encode", "runner.dit_step", "runner.vae_decode", "runner.color_pack")
STREAM = ("stream.upload", "stream.copy_wait", "stream.unpack")
VAE = ("vae.mid_attention", "vae.causal_pad", "vae.group_norm")


@pytest.fixture(scope="module")
def runner():
    vc = config.vae_tiny()
    dc = dataclasses.replace(config.dit_tiny(), vid_in_channels=2 * vc.latent_channels + 1,
                             vid_out_channels=vc.latent_channels)
    cfg = config.PipelineConfig(dit=dc, vae=vc, compute_dtype="float32", resolution=32, batch_size=5,
                                output_bits=8)
    g = torch.Generator().manual_seed(0)
    text = np.random.RandomState(0).randn(7, dc.txt_in_dim).astype(np.float32)
    return Runner(cfg, random_dit(dc, g, torch.float32), random_vae(vc, g, torch.float32), text, device="cpu")


def _traced(fn, path: Path):
    """The user ranges of ``fn()`` run under torch.profiler (CPU activity),
    read back from its exported Chrome trace: name -> [(start, end, thread)]."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    ranges = defaultdict(list)
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid")))
    return ranges


def _inside(child, parents) -> bool:
    s, e, tid = child
    return any(ps <= s and e <= pe and ptid == tid for ps, pe, ptid in parents)


@pytest.mark.parametrize("frames, batches", [(1, 1), (10, 2)], ids=["image", "clip"])
def test_generate_ranges_nest(runner, tmp_path, frames, batches):
    clip = np.random.RandomState(1).randint(0, 256, (frames, 24, 32, 3)).astype(np.uint8)
    out = []
    r = _traced(lambda: out.append(phases.generate(runner, clip, runner.cfg, packed=True)), tmp_path / "t.json")
    assert out[0].shape[0] == frames and out[0].dtype == np.uint8
    assert len(r["generate"]) == 1
    assert set(r) == {"generate", *STREAM, *STAGES, *VAE, "vae.conv_plain"}  # no other name, none renamed
    for name in STREAM + STAGES:
        assert len(r[name]) == batches, name  # one upload, one wait and one unpack a batch
        assert all(_inside(c, r["generate"]) for c in r[name]), name
    model = r["runner.vae_encode"] + r["runner.vae_decode"]
    for name in VAE:
        assert r[name] and all(_inside(c, model) for c in r[name]), name
    # the mid attention's GroupNorm inside it; the encoder's and the decoder's mid block each once a batch
    assert len(r["vae.mid_attention"]) == 2 * batches
    assert all(any(_inside(c, [m]) for c in r["vae.group_norm"]) for m in r["vae.mid_attention"])
    # the stream's host steps lie outside the model stages
    assert not any(_inside(c, r[s]) for c in r["stream.upload"] + r["stream.unpack"] for s in STAGES)


def _conv(cin, cout, kernel, fusion):
    g = torch.Generator().manual_seed(2)
    conv = CausalConv3d(kernel, cin, cout, "cpu", torch.float32,
                        spatial_pad=((1, 1), (1, 1)) if kernel[1] == 3 else ((0, 0), (0, 0)))
    norm = _norm(cin, "cpu", torch.float32)
    for leaf in (conv, norm):
        for name, buf in leaf.named_buffers():
            buf.copy_(torch.randn(buf.shape, generator=g))
    conv.gn_fusion = fusion
    return conv, norm


@pytest.mark.parametrize("route, cin, kernel, fusion", [
    ("k4", 128, (3, 3, 3), True),  # tables for K4, then one conv
    ("k1", 128, (3, 3, 3), False),  # GroupNorm + SiLU first (K8 + K9 on a card), then K1
    ("plain", 8, (3, 3, 3), False),  # off K1: F.conv3d
    ("plain-1x1x1", 128, (1, 1, 1), False),
])
def test_conv_routes_ranges(tmp_path, route, cin, kernel, fusion):
    conv, norm = _conv(cin, cin, kernel, fusion)
    x = torch.randn(1, 2, 4, 4, cin, generator=torch.Generator().manual_seed(3))
    assert conv.k1 == route.startswith("k")
    ctx = StreamCtx("init")
    r = _traced(lambda: conv(x, ctx, "c", gn=(norm, 4)), tmp_path / "t.json")
    assert len(r["vae.causal_pad"]) == 1
    assert len(r["vae.group_norm"]) == 1
    assert len(r["vae.conv_plain"]) == (0 if conv.k1 else 1)
    # the padding ends before the GroupNorm starts: the pass over the extended input is the norm's
    assert r["vae.causal_pad"][0][1] <= r["vae.group_norm"][0][0]


def test_span_without_a_profiler_enters_nothing(runner, monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    assert spans.span("x") is spans.NULL and spans.span("y") is spans.NULL
    monkeypatch.setattr(spans, "record_function", refused)
    clip = np.random.RandomState(4).randint(0, 256, (5, 24, 32, 3)).astype(np.uint8)
    assert phases.generate(runner, clip, runner.cfg, packed=True).shape[0] == 5
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function"):
            spans.span("z")


def test_span_under_a_profiler_is_a_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(spans.span("x"), torch.profiler.record_function)


def test_no_record_function_outside_the_helper():
    found = [str(p.relative_to(PORT)) for p in sorted(PORT.rglob("*.py"))
             if p != PORT / "utils" / "spans.py" and "record_function" in p.read_text()]
    assert found == []


def test_quiet_memory_summary_reads_nothing(monkeypatch, capsys):
    opened = []
    real_open = builtins.open

    def watched(path, *a, **kw):
        opened.append(str(path))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", watched)
    debug.Debug().peak_memory_summary()
    assert opened == [] and capsys.readouterr().out == ""
    debug.Debug().peak_memory_summary(force=True)
    assert "/proc/self/status" in opened and "Host RSS" in capsys.readouterr().out
