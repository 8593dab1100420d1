"""The arithmetic of the end-to-end metrics, on host numbers."""

from __future__ import annotations

import math
import statistics


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least a share ``q`` of all values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[max(0, math.ceil(q * len(vals)) - 1)]


def latency_quantile(latencies, offered: int, q: float, miss: float):
    """The ``q`` quantile of the latencies of ``offered`` requests, of
    which ``latencies`` came back: each one that never came (dropped or
    failed) counts as ``miss``, which lies above every latency."""
    if len(latencies) > offered:
        raise ValueError(f"{len(latencies)} latencies for {offered} offered")
    if latencies and max(latencies) >= miss:
        raise ValueError("a latency reaches the value of a miss")
    return nearest_rank(list(latencies) + [miss] * (offered - len(latencies)),
                        q)


def rate(count: int, seconds: float) -> float:
    """Work done per second of a window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and the third quartile as a share
    of the median (``statistics.quantiles``, exclusive method)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total = 0.0
    end = -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, start: float, stop: float):
    """The (start, end) stretches of [start, stop] that no interval
    covers."""
    out = []
    cur = start
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, stop)))
        cur = max(cur, b)
        if cur >= stop:
            break
    if cur < stop:
        out.append((cur, stop))
    return [(a, b) for a, b in out if b > a]
