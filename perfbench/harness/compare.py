"""What a run makes of its traffic's check (``perfbench/checks/<kind>.py``,
named by the traffic's ``check.kind``), whatever numbers the check reads:
each number's worst reading, and the verdict against the traffic's
limits."""

from __future__ import annotations


def worst(readings: list[dict], numbers) -> dict:
    """Each of ``numbers``' largest reading over several batches."""
    return {k: max(r[k] for r in readings) for k in numbers}


def verdict(reading: dict, limits: dict, numbers) -> bool:
    """Whether each of ``numbers`` is at or under its limit (NaN is not)."""
    return all(reading[k] <= limits[k] for k in numbers)
