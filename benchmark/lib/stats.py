"""The arithmetic of the end-to-end metrics and of the trace."""

from typing import List, Sequence, Tuple


def rate(pods_bound: int, intervals_s: Sequence[float]) -> float:
    """All pods bound over all the timed time."""
    total = float(sum(intervals_s))
    if total <= 0:
        raise ValueError("no timed interval")
    return pods_bound / total


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of `intervals` clipped to [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in union(intervals))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi] outside the union of `intervals`."""
    out, t = [], lo
    for a, b in union(intervals):
        if b <= lo or a >= hi:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out
