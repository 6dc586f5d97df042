"""The readers of the program's own ranges (metrics/stream_idle_ms_per_frame,
mid_attn_roofline, causal_pad_ms_per_frame, gn_ms_per_frame) on
hand-built Chrome trace events, against hand counts."""

import pytest

from portbench import catalog, probes, work
from portbench.run import Run
from portbench.trace import Trace

NEW = ("stream_idle_ms_per_frame", "mid_attn_roofline", "causal_pad_ms_per_frame", "gn_ms_per_frame")


class Events:
    def __init__(self):
        self.ev = []
        self.corr = 0

    def range(self, name, ts, end, tid=1):
        self.ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts, "tid": tid})

    def kernel(self, ts, end, launch_at=None, tid=1, name="k"):
        """A device event, launched on thread ``tid`` at ``launch_at`` (none: no launch record)."""
        self.corr += 1
        e = {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": end - ts, "tid": 7,
             "args": {"correlation": self.corr}}
        self.ev.append(e)
        if launch_at is not None:
            self.ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_at,
                            "dur": 1, "tid": tid, "args": {"correlation": self.corr}})

    def run(self, frames=3, calls=None):
        return Run(frames=frames, window_s=1.0, request_s=[], setup_s=0.0, peak_bytes=0, trace=Trace(self.ev),
                   calls=calls)


def read(name, run):
    return catalog.metric(name).read(run)


def _stream():
    """Device busy [5, 15], [40, 45], [60, 70], [110, 120]: idle [15, 40],
    [45, 60], [70, 110] in the window [5, 120]. Thread 1: generate [0, 100]
    holding runner.dit_step [30, 50] and phase.decode [65, 80], so its self
    time is [0, 30], [50, 65], [80, 100]."""
    ev = Events()
    for s, e in ((5, 15), (40, 45), (60, 70), (110, 120)):
        ev.kernel(s, e)
    ev.range("generate", 0, 100)
    ev.range("runner.dit_step", 30, 50)
    ev.range("phase.decode", 65, 80)
    ev.range("stream.unpack", 85, 95)  # a host step: self time of generate all the same
    return ev


def test_stream_idle_splits_gaps_at_generate_and_stage_borders():
    # [15, 40] is cut at the stage's start (30): 15; [45, 60] at its end (50): 10;
    # [70, 110] at the phase's end (80) and generate's end (100): 20
    assert read("stream_idle_ms_per_frame", _stream().run(frames=3)) == pytest.approx(45 / 1e3 / 3)


def test_stream_idle_two_threads():
    ev = _stream()
    ev.range("runner.vae_decode", 0, 100, tid=2)  # another thread's stage leaves thread 1's self time whole
    ev.range("generate", 100, 115, tid=2)  # another thread's request: [100, 110] of the last gap
    ev.range("generate", 102, 108)  # overlapping self time is counted once
    assert read("stream_idle_ms_per_frame", ev.run(frames=3)) == pytest.approx((45 + 10) / 1e3 / 3)


def test_stream_idle_outside_generate_is_not_counted():
    ev = Events()
    ev.kernel(0, 10)
    ev.kernel(50, 60)
    ev.range("generate", 0, 20)  # idle [10, 50]: only [10, 20] inside the request
    assert read("stream_idle_ms_per_frame", ev.run(frames=1)) == pytest.approx(10 / 1e3)


def _model():
    """vae.mid_attention [0, 100] on thread 1 holding vae.group_norm [5, 20];
    vae.causal_pad [200, 220]; kernels launched in each, one launched on
    thread 2 inside the mid attention's time, one outside every range."""
    ev = Events()
    ev.range("vae.mid_attention", 0, 100)
    ev.range("vae.group_norm", 5, 20)
    ev.kernel(300, 340, launch_at=10)  # the GroupNorm's: 40
    ev.kernel(330, 380, launch_at=50)  # the attention's: 50, overlapping the GroupNorm's by 10
    ev.kernel(500, 900, launch_at=60, tid=2)  # launched on another thread: nobody's here
    ev.range("vae.causal_pad", 200, 220)
    ev.kernel(400, 425, launch_at=210)
    ev.kernel(430, 432, launch_at=215)
    ev.kernel(1000, 1100, launch_at=250)  # outside every range
    ev.range("vae.group_norm", 260, 270)
    ev.kernel(1200, 1206, launch_at=265)
    return ev


def test_mid_attn_roofline():
    calls = probes.Calls({})
    calls.mid_attention += [work.Work(flops=989e12 * 6e-6), work.Work(bytes=3.35e12 * 4e-6)]  # least 6 + 4 us
    # busy: the union of [300, 340] and [330, 380], 80 us
    assert read("mid_attn_roofline", _model().run(calls=calls)) == pytest.approx(100.0 * 10 / 80)


def test_causal_pad_and_group_norm_per_frame():
    run = _model().run(frames=2)
    assert read("causal_pad_ms_per_frame", run) == pytest.approx(1000.0 * 27e-6 / 2)
    assert read("gn_ms_per_frame", run) == pytest.approx(1000.0 * (40 + 6) * 1e-6 / 2)


def test_a_range_without_device_work_reads_zero():
    ev = Events()
    ev.kernel(0, 10, launch_at=0)
    ev.range("vae.causal_pad", 20, 30)  # x_ext = x: nothing launched
    assert read("causal_pad_ms_per_frame", ev.run()) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_none_where_the_spans_are_absent(name):
    """The parent's traced run: the runner's ranges and probes.py's, none of
    the program's new ones."""
    ev = Events()
    ev.range("runner.vae_decode", 0, 100)
    ev.range("pb.conv", 10, 50)
    ev.kernel(20, 40, launch_at=15)
    calls = probes.Calls({})
    calls.mid_attention.append(work.Work(flops=1e9))
    assert read(name, ev.run(calls=calls)) is None
    assert read(name, Run(frames=3, window_s=1.0, request_s=[], setup_s=0.0, peak_bytes=0)) is None


@pytest.mark.parametrize("name", [n for n in NEW if n.endswith("_per_frame")])
def test_none_without_frames(name):
    ev = _model()
    ev.range("generate", 0, 2000)
    assert read(name, ev.run(frames=0)) is None
