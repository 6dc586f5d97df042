"""The run log: category lines, nested timers with a child breakdown, device
memory lines and the environment report (counterpart of
seedvr2_tpu/utils/debug.py). Memory is read from the CUDA caching
allocator of the run's device; a CPU run reports none.
"""

from __future__ import annotations

import platform
import subprocess
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

_CATEGORY_ICONS = {
    "setup": "🔧",
    "generation": "🎬",
    "vae": "🧩",
    "dit": "🧠",
    "video": "📼",
    "memory": "📊",
    "timing": "⏱️",
    "tip": "💡",
    "error": "❌",
    "alpha": "🎭",
    "sharding": "🕸️",
    "info": "ℹ️",
    "none": "",
}


def card_line(index: int = 0) -> Optional[str]:
    """``name, power limit`` of card ``index`` as nvidia-smi reports them;
    None where nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"-i={index}"],
                             capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


class Debug:
    """``enabled`` turns on every line; ``force=True`` lines always print.
    ``device``: where the memory lines read from (a CUDA device, or None)."""

    def __init__(self, enabled: bool = False, device=None):
        self.enabled = enabled
        self.device = torch.device(device) if device is not None else None
        self._timers: Dict[str, float] = {}
        self._stack: List[str] = []
        self._children: Dict[str, List[tuple]] = {}
        self._last_bytes: Optional[int] = None

    def log(self, msg: str, category: str = "info", force: bool = False, indent_level: int = 0) -> None:
        if not (self.enabled or force):
            return
        icon = _CATEGORY_ICONS.get(category, "")
        print(f"{'  ' * indent_level}{icon + ' ' if icon else ''}{msg}", flush=True)

    # ------------------------------- timers -------------------------------- #

    def start_timer(self, name: str) -> None:
        self._timers[name] = time.perf_counter()
        self._stack.append(name)
        self._children.setdefault(name, [])

    def end_timer(self, name: str, msg: str = "", show_breakdown: bool = False) -> float:
        """Seconds since start_timer(name), recorded under the enclosing
        timer; 0.0 for a timer that was not started."""
        t0 = self._timers.pop(name, None)
        if t0 is None:
            return 0.0
        dt = time.perf_counter() - t0
        if self._stack and self._stack[-1] == name:
            self._stack.pop()
        if self._stack:
            self._children.setdefault(self._stack[-1], []).append((name, dt))
        if msg:
            self.log(f"{msg}: {dt:.2f}s", category="timing")
        if show_breakdown:
            for child, cdt in self._children.get(name, ()):
                self.log(f"{child}: {cdt:.2f}s", category="timing", indent_level=1)
        return dt

    @contextmanager
    def timer(self, name: str, msg: str = ""):
        self.start_timer(name)
        try:
            yield
        finally:
            self.end_timer(name, msg or name)

    # ------------------------------- memory -------------------------------- #

    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def log_memory_state(self, label: str) -> None:
        """Allocated device memory, with the change since the last line."""
        if not (self.enabled and self._cuda()):
            return
        used = torch.cuda.memory_allocated(self.device)
        total = torch.cuda.get_device_properties(self.device).total_memory
        delta = "" if self._last_bytes is None else f" ({(used - self._last_bytes) / 2**30:+.2f})"
        self._last_bytes = used
        self.log(f"{label}: device {used / 2**30:.2f}/{total / 2**30:.2f} GiB{delta}", category="memory")

    def peak_memory_gib(self) -> Optional[float]:
        """torch.cuda.max_memory_allocated of the device, GiB; None on a CPU."""
        return torch.cuda.max_memory_allocated(self.device) / 2**30 if self._cuda() else None

    def peak_memory_summary(self, force: bool = False) -> None:
        """The device's peak allocated memory and the host's resident set;
        read only where a line will print (``enabled`` or ``force``)."""
        if not (self.enabled or force):
            return
        peak = self.peak_memory_gib()
        if peak is not None:
            self.log(f"Peak device memory: {peak:.2f} GiB (torch.cuda.max_memory_allocated)", category="memory",
                     force=force)
        try:
            with open("/proc/self/status") as fh:
                rss = next((int(line.split()[1]) for line in fh if line.startswith("VmRSS:")), 0)
        except OSError:
            rss = 0
        if rss:
            self.log(f"Host RSS: {rss / 2**20:.2f} GiB", category="memory", force=force)

    def tensor_census(self, top: int = 10) -> list:
        """A gc walk of the live tensors on the run's device (``device``; the
        CPU when none is set), grouped by (shape, dtype): [(bytes, count,
        shape, dtype)], largest first; the ``top`` largest groups are
        logged when the log is enabled. A view counts its own size beside
        its base's."""
        import gc
        import warnings

        device = self.device or torch.device("cpu")
        groups: Dict[tuple, list] = {}
        with warnings.catch_warnings():  # isinstance() wakes deprecated module proxies
            warnings.simplefilter("ignore")
            for obj in gc.get_objects():
                try:
                    if not isinstance(obj, torch.Tensor) or obj.device.type != device.type:
                        continue
                    if device.index is not None and obj.device.index != device.index:
                        continue
                    g = groups.setdefault((tuple(obj.shape), str(obj.dtype)), [0, 0])
                    g[0] += obj.numel() * obj.element_size()
                    g[1] += 1
                except Exception:  # an object that fails isinstance or shape queries mid-collection
                    continue
        rows = sorted(((b, n, shape, dt) for (shape, dt), (b, n) in groups.items()), reverse=True)
        if self.enabled and rows:
            total = sum(r[0] for r in rows)
            self.log(f"Live tensors on {device}: {sum(r[1] for r in rows)} ({total / 2**30:.2f} GiB)",
                     category="memory")
            for b, n, shape, dt in rows[:top]:
                self.log(f"{n}x {dt}{list(shape)}: {b / 2**30:.3f} GiB", category="memory", indent_level=1)
        return rows

    @contextmanager
    def profile(self, logdir: Optional[str] = None):
        """A torch.profiler trace (CPU and CUDA activities) of the region,
        written as a Chrome trace (``trace.json``) under ``logdir`` (default
        the temporary directory's ``seedvr2_profile``); open it in
        chrome://tracing or Perfetto."""
        import os
        import tempfile

        logdir = logdir or os.path.join(tempfile.gettempdir(), "seedvr2_profile")
        os.makedirs(logdir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        self.log(f"Profiler trace written to {path}", category="timing", force=True)

    def environment_report(self, attention_mode: str = "fused") -> None:
        """OS, Python, torch and CUDA, the card with its power limit, the
        attention mode and whether the native frame conversions built."""
        if not self.enabled:
            return
        from ..io.frameops import available as native_ok

        self.log(f"OS: {platform.platform()}", category="setup")
        self.log(f"Python: {platform.python_version()}  torch: {torch.__version__}  CUDA: {torch.version.cuda}",
                 category="setup")
        if self._cuda():
            card = card_line(self.device.index or 0) or torch.cuda.get_device_name(self.device)
            self.log(f"Device: {self.device} {card}", category="setup")
        else:
            self.log(f"Device: {self.device or 'cpu'}", category="setup")
        self.log(f"Attention mode: {attention_mode}", category="setup")
        self.log(f"Native frameops: {'available' if native_ok() else 'numpy fallback'}", category="setup")
