"""The port's own spans among the traced stretch's host records.

A program span is a host record whose name starts with :data:`PREFIX`
(``interpolate_antialiasing_tpu_torch/utils/trace.py`` opens them while a
profiler runs).  Its layer is the second word of its name, ``build`` (the
body of a cached function) counted as ``tables``.  Its self time is its duration
less the union of its direct program-span children: the aten operators
inside it are its own time.  Spans nest by ``with`` on one thread, so the
self times of a tree add up to its outermost span.  Times are microseconds
on the profiler's clock, as in :mod:`perfbench.harness.trace`.
"""

from __future__ import annotations

from collections import defaultdict

from perfbench.harness.trace import Record, idle_gaps

PREFIX = "ia."
BUILD = "ia.build."


def program_spans(host: list[Record]) -> list[Record]:
    return [r for r in host if r.name.startswith(PREFIX)]


def layer(name: str) -> str:
    """``ia.<layer>.<what>``'s layer; ``build`` is ``tables``."""
    word = name.split(".")[1]
    return "tables" if word == "build" else word


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _tree(spans: list[Record]) -> tuple[list[Record], list[list[tuple[float, float]]],
                                        list[Record]]:
    """``(spans in start order, each one's direct children's intervals,
    the outermost spans)``."""
    ordered = sorted(spans, key=lambda r: (r.start, -r.end))
    children: list[list[tuple[float, float]]] = [[] for _ in ordered]
    outer, stack = [], []
    for i, r in enumerate(ordered):
        while stack and ordered[stack[-1]].end <= r.start:
            stack.pop()
        if stack:
            p = ordered[stack[-1]]
            children[stack[-1]].append((r.start, min(r.end, p.end)))
        else:
            outer.append(r)
        stack.append(i)
    return ordered, children, outer


def self_us_by_layer(spans: list[Record]) -> dict[str, float]:
    """Summed self time of the program spans by layer, in microseconds."""
    ordered, children, _ = _tree(spans)
    out: dict[str, float] = defaultdict(float)
    for r, kids in zip(ordered, children):
        out[layer(r.name)] += (r.end - r.start) - _length(_union(kids))
    return dict(out)


def outermost(spans: list[Record]) -> list[Record]:
    """The program spans that no other program span holds."""
    return _tree(spans)[2]


def idle_in_program_us(device: list[Record], spans: list[Record], window: Record) -> float:
    """Microseconds of the window in which no device record runs while a
    program span is open: :func:`trace.idle_gaps` against the union of the
    outermost program spans."""
    inside = _union((max(r.start, window.start), min(r.end, window.end))
                    for r in outermost(spans) if r.end > window.start and r.start < window.end)
    total, k = 0.0, 0
    for s, e in idle_gaps(device, window):  # sorted, disjoint, as `inside`
        while k < len(inside) and inside[k][1] <= s:
            k += 1
        j = k
        while j < len(inside) and inside[j][0] < e:
            total += min(e, inside[j][1]) - max(s, inside[j][0])
            j += 1
    return total


def layer_us_per_call(rec: dict, name: str) -> float | None:
    """Self time of layer ``name`` per traced call, in microseconds; None
    without host records or without a program span among them."""
    spans = program_spans(rec.get("host") or [])
    if not spans:
        return None
    return self_us_by_layer(spans).get(name, 0.0) / rec["trace_calls"]
