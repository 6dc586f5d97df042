"""Named host ranges of the program on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a torch
profiler is recording, so a range lands in the same Chrome trace as the
device events, on Kineto's clock; otherwise it is ``NULL``, one shared
no-op context. Entering a ``record_function`` costs ~12 us on the host
even when nothing records; the check costs ~0.1 us, so a span may sit on
every conv and GroupNorm call.

Every range of the port goes through here:

- ``generate``: a whole ``phases.generate`` call, every route;
- ``stream.upload``, ``stream.copy_wait``, ``stream.unpack``: the fused
  path's host steps in ``phases.generate_streaming`` (a batch's host
  preparation and upload; the wait on its started copies; the codes
  written into the output);
- ``runner.<stage>`` (pipeline/runner.py), ``phase.<name>``
  (pipeline/phases.py): the stages of a batch and the 4-phase path;
- ``vae.mid_attention``, ``vae.causal_pad``, ``vae.group_norm``,
  ``vae.conv_plain`` (models/vae/): the VAE's passes around its conv
  kernels;
- ``dit.linear`` (models/dit/nadit.py:DiTLinear): every linear of the
  DiT, one range a product (patch in and out, text in, the time
  embedding, each layer's qkv, out and MLP of both streams), K7 on an
  int8 weight; the bias of a row-parallel layer is added outside it.

A request's ranges are those nested in its ``generate`` range on its
thread.
"""

from __future__ import annotations

import contextlib

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records; else NULL."""
    return record_function(name) if _profiler_enabled() else NULL
