"""The general traffic kind, ``clips``: it reads a mix's parameters
(``portbench/traffic/<name>.json``, ``"kind": "clips"``) and makes the
cell's requests from the run's seed.

A mix file holds:

- ``sizes``: the input frame sizes, [height, width] each;
- ``frames``: frames a request (1 for an image, 25 for a clip);
- ``resolution`` (a fixed output short side) or ``upscale`` (the output
  short side as a multiple of the input's);
- ``pool``: distinct inputs drawn for each size (requests cycle through
  them, so that no input is drawn inside the measured window);
- ``pipeline``: PipelineConfig fields every request runs with (the CLI's
  settings: batch size, colour fix, tiling, output bits, ...);
- ``loop``: "closed", one client: a request is sent when the last one has
  returned.

The sizes come in blocks, each block a permutation of ``sizes`` drawn from
the seed, so that every seed runs the same mix of sizes in another order;
the measured window ends on a whole block (``block``), so every window
holds each size equally often. Each request also carries its own seed for
the program's noise draw. Inputs are uniform random uint8 RGB frames; a
request goes to ``phases.generate(..., packed=True)``, which returns the
8-bit RGB codes [T, H, W, 3] that are compared.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

SEQUENCE = 4096  # requests drawn ahead; a longer window wraps around


class Request(NamedTuple):
    index: int
    frames: np.ndarray  # uint8 [T, H, W, 3]
    resolution: int
    seed: int


class Mix:
    def __init__(self, params: dict, seed: int):
        self.params = params
        if params.get("loop", "closed") != "closed":
            raise ValueError("only closed-loop traffic is generated")
        self.sizes: List[Tuple[int, int]] = [tuple(s) for s in params["sizes"]]
        rng = np.random.default_rng(seed)
        n = len(self.sizes)
        self.order = np.concatenate([rng.permutation(n) for _ in range(-(-SEQUENCE // n))])[:SEQUENCE]
        self.seeds = rng.integers(0, 2**31 - 1, SEQUENCE)
        pool = int(params.get("pool", 1))
        T = int(params["frames"])
        self.inputs = [[rng.integers(0, 256, (T, h, w, 3), dtype=np.uint8) for _ in range(pool)]
                       for h, w in self.sizes]
        self.block = n  # requests of one block of sizes
        self.batch = int(params["pipeline"].get("batch_size", 5))

    def resolution(self, size: Tuple[int, int]) -> int:
        if "resolution" in self.params:
            return int(self.params["resolution"])
        return int(round(self.params["upscale"] * min(size)))

    def request(self, i: int) -> Request:
        k = i % SEQUENCE
        s = int(self.order[k])
        pool = self.inputs[s]
        frames = pool[(i // len(self.sizes)) % len(pool)]
        return Request(i, frames, self.resolution(self.sizes[s]), int(self.seeds[k]))

    def call(self, runner, cfg, req: Request, frames=None):
        """One request through the program's entry: its output codes."""
        from seedvr2_tpu_torch.pipeline import phases

        rc = cfg.replace(resolution=req.resolution, seed=req.seed)
        return phases.generate(runner.with_config(rc), req.frames if frames is None else frames, rc, packed=True)

    def warm(self, runner, cfg) -> None:
        """One batch of each size: every shape of the cell once (one batch of
        a clip covers the clip's shapes)."""
        first = {}
        for i in range(len(self.sizes)):
            first.setdefault(int(self.order[i]), i)
        for i in sorted(first.values()):
            req = self.request(i)
            self.call(runner, cfg, req, req.frames[: self.batch])

    @staticmethod
    def frames_out(out) -> int:
        return len(out)

    @staticmethod
    def program_codes(out, lo: int, hi: int) -> np.ndarray:
        """Frames [lo, hi) of a request's output, uint8 [T, H, W, 3]."""
        return out[lo:hi]

    def reference_codes(self, ref, req: Request, lo: int, hi: int, device) -> np.ndarray:
        """The reference's codes of frames [lo, hi) of a request (one batch)."""
        import torch

        frames = torch.from_numpy(req.frames[lo:hi]).to(device)
        return ref.upscale(frames, req.resolution, req.seed).cpu().numpy()

    def largest(self, indices) -> int:
        """The request among ``indices`` with the most output pixels."""
        def pixels(i):
            r = self.request(i)
            h, w = r.frames.shape[1:3]
            return r.frames.shape[0] * h * w * (r.resolution / min(h, w)) ** 2
        return max(indices, key=pixels)
