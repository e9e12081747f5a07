"""Order statistics of the benchmark's samples."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) of ``values`` by nearest rank:
    the least sample with at least ``q`` percent of the samples at or below
    it.  Every sample counts; nothing is interpolated."""
    if not values:
        raise ValueError("percentile of no samples")
    if not 0 < q <= 100:
        raise ValueError(f"q must be in (0, 100], got {q}")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]
