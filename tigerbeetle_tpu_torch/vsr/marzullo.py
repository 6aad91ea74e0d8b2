"""Marzullo's interval-agreement algorithm.

Mirrors upstream src/vsr/marzullo.zig: given per-source
clock-offset intervals [lo, hi], find the smallest interval contained in the
largest number of source intervals. The cluster clock (vsr/clock.py) feeds it
one interval per remote replica; the result bounds the true cluster offset of
the local clock if a majority of source clocks are accurate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class Interval:
    lower_bound: int
    upper_bound: int
    # How many source intervals contain this interval.
    sources_true: int


def smallest_interval(tuples: List[Tuple[int, int]]) -> Interval:
    """Smallest interval consistent with the most sources.

    Sweep over sorted endpoints (marzullo.zig smallest_interval): at each
    start edge the overlap count rises, at each end edge it falls; the
    best window is the one with the maximal count, ties broken by taking
    the first (which also yields the smallest such interval because starts
    sort before ends at equal offsets).
    """
    if not tuples:
        return Interval(0, 0, 0)
    # (offset, type): type -1 = start (sorts before end at equal offset so
    # touching intervals count as overlapping), +1 = end.
    edges: List[Tuple[int, int]] = []
    for lo, hi in tuples:
        assert lo <= hi
        edges.append((lo, -1))
        edges.append((hi, +1))
    edges.sort()

    best = 0
    count = 0
    lower = 0
    upper = 0
    for i, (offset, kind) in enumerate(edges):
        count -= kind
        if count > best:
            best = count
            lower = offset
            # The matching upper bound is the next edge's offset (the
            # window shrinks as soon as any member interval ends).
            upper = edges[i + 1][0]
    return Interval(lower, upper, best)
