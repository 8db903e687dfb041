"""The arithmetic of the metrics: shares of the window, tails, unions."""

from __future__ import annotations

import statistics


def overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def window_share(t0: float, t1: float, w0: float, w1: float) -> float:
    """The share of a call [t0, t1] that lies in the window [w0, w1]: a
    call that straddles an edge counts for the part of it inside, so a rate
    over the window takes all of the window's work and none outside it."""
    if t1 <= t0:
        return 1.0 if w0 <= t0 < w1 else 0.0
    return overlap(t0, t1, w0, w1) / (t1 - t0)


def window_work(calls, w0: float, w1: float) -> float:
    """Work done in the window: each call's work times its share in it."""
    return sum(c.work * window_share(c.t0, c.t1, w0, w1) for c in calls)


def window_calls(calls, w0: float, w1: float) -> float:
    return sum(window_share(c.t0, c.t1, w0, w1) for c in calls)


def started_in(calls, w0: float, w1: float) -> list:
    """The calls issued while the window was open: all of them, also those
    that end after it closes."""
    return [c for c in calls if w0 <= c.t0 < w1]


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, inclusive method)."""
    values = list(values)
    if len(values) < 2:
        raise ValueError("p95 needs at least two values")
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def union(intervals) -> list:
    """Merge (start, end) intervals into disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def clip(intervals, w0: float, w1: float) -> list:
    return [(max(a, w0), min(b, w1)) for a, b in intervals if b > w0 and a < w1]


def busy(intervals, w0: float, w1: float) -> float:
    """Seconds of [w0, w1] covered by at least one interval."""
    return sum(b - a for a, b in union(clip(intervals, w0, w1)))


def gaps(intervals, w0: float, w1: float) -> list:
    """The idle stretches of [w0, w1]: (start, end), longest first."""
    out, at = [], w0
    for a, b in union(clip(intervals, w0, w1)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < w1:
        out.append((at, w1))
    return sorted(out, key=lambda g: g[0] - g[1])
