"""How ``correct`` is decided: the program's 8-bit codes, as the measured
window produced them, against the plain reference's codes for the same
frames, seed and weights.

Two numbers, each with its limit from the cell's file:

- ``mean_code_gap``: the mean absolute difference of the codes over every
  compared value (every pixel and channel of every sampled unit);
- ``worst_frame_gap``: the largest mean absolute difference of any one
  compared frame, so that a single frame gone wrong is not averaged away.

A unit whose shape differs from the reference's fails outright.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

NAMES = ("mean_code_gap", "worst_frame_gap")


def gaps(pairs: List[Tuple[np.ndarray, np.ndarray]]) -> Dict[str, float]:
    """pairs: (program codes, reference codes), uint8 [T, H, W, 3] each.
    A shape mismatch reads as the widest gap, 255."""
    total = count = 0
    worst = 0.0
    for prog, ref in pairs:
        if prog.shape != ref.shape:
            return {n: 255.0 for n in NAMES}
        d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
        total += int(d.sum(dtype=np.int64))
        count += d.size
        worst = max(worst, float(d.reshape(d.shape[0], -1).mean(axis=1).max()))
    return {"mean_code_gap": total / count, "worst_frame_gap": worst}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every reading within its limit, {name: {value, limit}})."""
    checks = {n: {"value": readings[n], "limit": float(limits[n])} for n in NAMES}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
