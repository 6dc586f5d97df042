"""Host <-> device copies that do not stall the host on the card's queue.

A plain ``tensor.to("cuda")`` from pageable host memory, or ``.cpu()`` of a
CUDA tensor, waits until the compute stream has drained: the host then
cannot queue the next batch while the card works on this one. On a card:

- ``to_device`` stages a host array in pinned memory and copies it
  without blocking (the caching host allocator keeps the pinned block
  until the copy has run);
- ``HostCopies`` copies device tensors to pinned host buffers on one side
  stream. A copy waits on an event recorded on the compute stream after
  the tensor's last kernel, its source is marked as used by the side
  stream (``record_stream``: the caching allocator does not hand the
  memory to later kernels before the copy has read it), and ``wait`` waits
  on the copy's own event only.

On a CPU device both are the plain operations: the tensors already live
in host memory.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and a non-blocking
    copy on a card, a plain view on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """One device -> host copy in flight: ``wait()`` returns the host
    tensor once the copy has run."""

    def __init__(self, host: torch.Tensor, done: Optional[torch.cuda.Event]):
        self.host = host
        self.done = done

    def wait(self) -> torch.Tensor:
        if self.done is not None:
            self.done.synchronize()
        return self.host


class HostCopies:
    """Device -> host copies of one device on a dedicated copy stream (a
    CUDA device), or plain host tensors (a CPU device)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def start(self, t: torch.Tensor) -> HostCopy:
        """Queue the copy of ``t`` behind the work already queued on the
        current (compute) stream; returns at once."""
        if self.stream is None:
            return HostCopy(t, None)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        self.stream.wait_event(ready)
        with torch.cuda.stream(self.stream):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        t.record_stream(self.stream)
        return HostCopy(host, done)
