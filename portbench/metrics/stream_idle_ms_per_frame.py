"""Device-idle time per output frame while the host is in the self time of
the program's ``generate`` ranges: inside a ``generate`` range and outside
every ``runner.*`` and ``phase.*`` range of the same thread (the request's
set-up, the output stream's upload, copy waits and unpack). Idle is the
gaps between the device's kernel, copy and memset intervals, from the
trace's first device event to its last. The part of idle_share that the
entry and the output stream leave exposed, apart from launch-bound gaps
inside the model stages."""

from portbench.window import gaps, merged

UNIT, BETTER, SOURCE = "ms/frame", "lower", "program_span"
LAYER = "output stream"
STAGES = ("runner.", "phase.")


def self_time(ranges) -> list:
    """The stretches of every thread's ``generate`` ranges that no stage
    range of that thread covers, merged over the threads (``ranges``:
    Trace.ranges, name -> [(start, end, thread)])."""
    stages = {}
    for name, inst in ranges.items():
        if name.startswith(STAGES):
            for s, e, tid in inst:
                stages.setdefault(tid, []).append((s, e))
    out = []
    for s, e, tid in ranges.get("generate", ()):
        out.extend(gaps(stages.get(tid, ()), s, e))
    return merged(out)


def overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    tr = run.trace
    if tr is None or not tr.intervals or not run.frames or not tr.ranges.get("generate"):
        return None
    idle = gaps(merged(tr.intervals), *tr.window_us())
    return overlap(idle, self_time(tr.ranges)) / 1e3 / run.frames
