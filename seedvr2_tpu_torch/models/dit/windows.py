"""3D shifted-window partitioning, computed on the host (the port's copy of
seedvr2_tpu/models/dit/windows.py: window_plan and WindowPlan, same
numbers).

For a patched latent shape (t, h, w) a plan holds the gather indices of
every window's tokens, padded to the longest window with a validity mask,
and the inverse permutation that scatters window slots back to token order.
Window sizes are normalised to 720p: the window size in latent tokens does
not depend on the resolution, so a larger frame has more windows of the
same shape.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np

Slice3 = Tuple[slice, slice, slice]


def window_sizes_720p(size: Tuple[int, int, int], num_windows: Tuple[int, int, int]) -> Tuple[int, int, int]:
    t, h, w = size
    rnt, rnh, rnw = num_windows
    scale = math.sqrt((45 * 80) / (h * w))
    resized_h, resized_w = round(h * scale), round(w * scale)
    return math.ceil(min(t, 30) / rnt), math.ceil(resized_h / rnh), math.ceil(resized_w / rnw)


def _axis_cuts(extent: int, win: int, shifted: bool) -> List[Tuple[int, int]]:
    """Half-open (start, stop) intervals covering [0, extent). Unshifted:
    aligned cuts every ``win`` tokens, the last one clipped. Shifted (only
    when the axis holds more than one window): boundaries at
    int((i + 0.5) * win), a leading and a trailing partial window."""
    if win >= extent:
        return [(0, extent)]
    if not shifted:
        return [(lo, min(lo + win, extent)) for lo in range(0, extent, win)]
    cuts: List[Tuple[int, int]] = []
    hi = 0
    i = 0
    while hi < extent:
        lo = hi
        hi = min(int((i + 0.5) * win), extent)
        i += 1
        if hi > lo:
            cuts.append((lo, hi))
    return cuts


def _grid(size: Tuple[int, int, int], num_windows: Tuple[int, int, int], shifted: bool) -> List[Slice3]:
    """Per-axis cuts as slice triples, ordered w-major, then h, then t."""
    t, h, w = size
    wt, wh, ww = window_sizes_720p(size, num_windows)
    out: List[Slice3] = []
    for w_lo, w_hi in _axis_cuts(w, ww, shifted):
        for h_lo, h_hi in _axis_cuts(h, wh, shifted):
            for t_lo, t_hi in _axis_cuts(t, wt, shifted):
                out.append((slice(t_lo, t_hi), slice(h_lo, h_hi), slice(w_lo, w_hi)))
    return out


class WindowPlan(NamedTuple):
    """Static gather/scatter plan for one (shape, method) pair."""

    index: np.ndarray  # [n_win, max_len] int32 into flat THW
    valid: np.ndarray  # [n_win, max_len] bool
    inverse: np.ndarray  # [L] int32 into flat (n_win * max_len)
    shapes: Tuple[Tuple[int, int, int], ...]  # per-window (t, h, w)
    lens: np.ndarray  # [n_win] int32 true lengths

    @property
    def n_win(self) -> int:
        return self.index.shape[0]

    @property
    def max_len(self) -> int:
        return self.index.shape[1]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@lru_cache(maxsize=256)
def window_plan(
    size: Tuple[int, int, int],
    num_windows: Tuple[int, int, int],
    shifted: bool,
    pad_to_multiple: int = 1,
) -> WindowPlan:
    """The dense plan; ``pad_to_multiple`` rounds max_len up."""
    t, h, w = size
    slices = _grid(size, num_windows, shifted)
    flat = np.arange(t * h * w, dtype=np.int32).reshape(t, h, w)
    idx_list = [flat[st, sh, sw].reshape(-1) for (st, sh, sw) in slices]
    shapes = tuple(
        (len(range(*st.indices(t))), len(range(*sh.indices(h))), len(range(*sw.indices(w))))
        for (st, sh, sw) in slices
    )
    lens = np.array([x.size for x in idx_list], dtype=np.int32)
    max_len = _round_up(int(lens.max()), pad_to_multiple)
    n = len(idx_list)
    index = np.zeros((n, max_len), dtype=np.int32)
    valid = np.zeros((n, max_len), dtype=bool)
    for i, ids in enumerate(idx_list):
        index[i, : ids.size] = ids
        valid[i, : ids.size] = True
    slot = np.arange(n * max_len, dtype=np.int32).reshape(n, max_len)
    inverse = np.empty(t * h * w, dtype=np.int32)
    inverse[index[valid]] = slot[valid]
    return WindowPlan(index, valid, inverse, shapes, lens)
