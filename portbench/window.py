"""The arithmetic of a measured window, kept apart so that tests can hold it
to hand counts."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def rate(units: int, window_s: float) -> float:
    """Work completed per second over the whole window."""
    return units / window_s


def window_bounds(spans: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    """From the first request's start to the last one's end."""
    return min(s for s, _ in spans), max(e for _, e in spans)


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank: the smallest
    value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100.0 * len(ordered))) - 1]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in merged(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
