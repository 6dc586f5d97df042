"""The device trace of a traced window, read from torch.profiler's Chrome
trace (CPU and CUDA activities).

Every device event (kernel, copy, memset) is tied through its correlation
id to the host call that launched it, through either of CUDA's launch APIs
(the kernels launched through ctypes included). A host range
(``record_function``) owns the device events launched while it was open on
the same thread, in nested ranges too. Of a range's instances, ``spans``
gives each one's device span (its first event's start to its last event's
end, idle gaps inside included) and ``busy`` the union of its events'
intervals.
"""

from __future__ import annotations

import bisect
import gzip
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .window import gaps, merged, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: List[dict]):
        self.device: List[dict] = []
        launches: Dict[int, Tuple[float, int]] = {}
        self.ranges: Dict[str, List[Tuple[float, float, int]]] = defaultdict(list)
        self.host_ops: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X":
                continue
            if cat in DEVICE_CATS:
                self.device.append(e)
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (float(e["ts"]), e.get("tid"))
            elif cat == "user_annotation":
                self.ranges[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid")))
                self.host_ops[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
            elif cat == "cpu_op":
                self.host_ops[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
        self.device.sort(key=lambda e: float(e["ts"]))
        # each device event's launch: (host time, thread), or None where the trace lacks it
        self.launch = [launches.get(e.get("args", {}).get("correlation")) for e in self.device]
        self.unlaunched = sum(1 for x in self.launch if x is None)
        self.intervals = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in self.device]

    @classmethod
    def load(cls, path: str) -> "Trace":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            return cls(json.load(f)["traceEvents"])

    # ------------------------------------------------------------------ #

    def busy_s(self) -> float:
        return union_length(self.intervals) / 1e6

    def _owned(self, name: str) -> List[List[int]]:
        """For each instance of range ``name``: the indices of the device
        events launched inside it (instances of one name do not overlap on
        a thread)."""
        inst = sorted(self.ranges.get(name, ()))
        starts = [s for s, _, _ in inst]
        owned: List[List[int]] = [[] for _ in inst]
        for i, la in enumerate(self.launch):
            if la is None:
                continue
            t, tid = la
            j = bisect.bisect_right(starts, t) - 1
            while j >= 0 and inst[j][2] != tid:  # the latest instance on the launching thread
                j -= 1
            if j >= 0 and t <= inst[j][1]:
                owned[j].append(i)
        return owned

    def spans(self, name: str) -> List[float]:
        """Each instance's device span, seconds (instances without device
        events left out)."""
        out = []
        for idx in self._owned(name):
            if idx:
                out.append((max(self.intervals[i][1] for i in idx) - min(self.intervals[i][0] for i in idx)) / 1e6)
        return out

    def busy(self, name: str, exclude: Optional[str] = None) -> float:
        """Seconds of device time (the union of intervals) of the events that
        the instances of ``name`` launched, less those launched inside a
        range ``exclude``."""
        keep = {i for idx in self._owned(name) for i in idx}
        if exclude is not None:
            keep -= {i for idx in self._owned(exclude) for i in idx}
        return union_length(self.intervals[i] for i in keep) / 1e6

    def copies_s(self, kind: str) -> float:
        """Summed device time of the copies whose name holds ``kind`` (DtoH, HtoD)."""
        return sum(float(e.get("dur", 0)) for e in self.device
                   if e.get("cat") == "gpu_memcpy" and kind in e.get("name", "")) / 1e6

    def top_ops(self, n: int = 10, inside: Optional[str] = None, exclude: Optional[str] = None) -> List[List]:
        """The device operations that took the most time, [name, seconds]:
        of the whole trace, or of those launched inside range ``inside``
        and outside range ``exclude``."""
        keep = range(len(self.device))
        if inside is not None:
            keep = {i for idx in self._owned(inside) for i in idx}
            if exclude is not None:
                keep -= {i for idx in self._owned(exclude) for i in idx}
        by: Dict[str, float] = defaultdict(float)
        for i in keep:
            s, t = self.intervals[i]
            by[self.device[i].get("name", "?")[:160]] += (t - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, lo_us: float, hi_us: float, n: int = 10) -> List[List]:
        """Idle device time inside [lo, hi], summed by the innermost host
        range or op open (on the thread that launched most work) at each
        gap's middle."""
        threads: Dict[int, int] = defaultdict(int)
        for la in self.launch:
            if la is not None:
                threads[la[1]] += 1
        tid = max(threads, key=threads.get) if threads else None
        ops = sorted(self.host_ops.get(tid, ()), key=lambda o: (o[0], -o[1]))
        by: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[float, float, str]] = []  # open ops, outermost first (they nest on a thread)
        k = 0
        for a, b in gaps(merged(self.intervals), lo_us, hi_us):
            mid = (a + b) / 2
            while k < len(ops) and ops[k][0] <= mid:
                while stack and stack[-1][1] < ops[k][0]:
                    stack.pop()
                stack.append(ops[k])
                k += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            by[(stack[-1][2] if stack else "host code outside any op")[:160]] += (b - a) / 1e6
        return [[k_, v] for k_, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def window_us(self) -> Tuple[float, float]:
        """The first and last device timestamps."""
        return min(s for s, _ in self.intervals), max(e for _, e in self.intervals)
