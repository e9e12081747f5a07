"""The traced stretch's records, and the arithmetic on them.

:func:`records` turns torch.profiler's events into plain tuples: the
device records (every event the profiler timed on the card: kernels,
copies, fills), the host events of the thread that ran the stretch, and
the stretch's own span.  The rest works on those tuples alone, so the
CPU tests feed it synthetic records.  Times are microseconds on the
profiler's clock.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

WINDOW_SPAN = "perfbench.window"
CALL_SPAN = "perfbench.call"
SYNC_SPAN = "perfbench.sync"
_NAME_CHARS = 160  # kernel names are long C++ signatures


class Record(NamedTuple):
    name: str
    start: float
    end: float


def records(events) -> tuple[list[Record], list[Record], Record]:
    """``(device, host, window)`` from ``prof.events()``: the device
    records that start inside the window, spans left out (the sum of
    their durations is the arithmetic of
    ``utils/timing.device_seconds_from_trace`` of
    ``interpolate_antialiasing_tpu_torch``), the host events of the
    window's thread, and the :data:`WINDOW_SPAN` event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.name == WINDOW_SPAN and e.device_type != cuda]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {WINDOW_SPAN} span in the trace, found {len(spans)}")
    span = spans[0]
    window = Record(WINDOW_SPAN, span.time_range.start, span.time_range.end)
    device, host = [], []
    for e in events:
        r = Record(e.name, e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            # a span's device-side copy (Kineto's gpu_user_annotation) is no work
            if not e.is_user_annotation and window.start <= r.start < window.end:
                device.append(r)
        elif e.thread == span.thread:
            host.append(r)
    return device, host, window


def device_seconds(device: list[Record]) -> float:
    """Summed durations of the device records."""
    return sum(r.end - r.start for r in device) / 1e6


def records_per_call(device: list[Record], host: list[Record]) -> list[int]:
    """The device records that start inside each call's span and the
    synchronise after it, one count per call."""
    calls = sorted(r for r in host if r.name == CALL_SPAN)
    syncs = sorted(r for r in host if r.name == SYNC_SPAN)
    starts = sorted(r.start for r in device)
    return [bisect.bisect_left(starts, s.end) - bisect.bisect_left(starts, c.start)
            for c, s in zip(calls, syncs)]


def busy_seconds(device: list[Record], window: Record) -> float:
    """Seconds of the window in which at least one device record ran: the
    union of their intervals, clipped to the window."""
    total, cur_s, cur_e = 0.0, None, None
    for r in sorted(device, key=lambda r: r.start):
        s, e = max(r.start, window.start), min(r.end, window.end)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def idle_gaps(device: list[Record], window: Record) -> list[tuple[float, float]]:
    """The intervals of the window in which no device record ran."""
    gaps, t = [], window.start
    for r in sorted(device, key=lambda r: r.start):
        if r.start > t:
            gaps.append((t, min(r.start, window.end)))
        t = max(t, r.end)
        if t >= window.end:
            break
    if t < window.end:
        gaps.append((t, window.end))
    return [(s, e) for s, e in gaps if e > s]


def _label_gaps(gaps, host: list[Record]) -> list[str]:
    """What the host was doing in each gap: the outermost and the innermost
    host event that hold the gap's middle (``outer > inner``)."""
    ordered = sorted(host, key=lambda r: (r.start, -r.end))
    labels, active, k = [], [], 0
    for s, e in sorted(gaps):
        mid = (s + e) / 2
        while k < len(ordered) and ordered[k].start <= mid:
            active.append(ordered[k])
            k += 1
        active = [r for r in active if r.end > mid]
        inside = [r for r in active if r.name != WINDOW_SPAN]
        if not inside:
            labels.append("(between calls)")
        elif len(inside) == 1:
            labels.append(inside[0].name[:_NAME_CHARS])
        else:
            labels.append(f"{inside[0].name} > {inside[-1].name}"[:_NAME_CHARS])
    return labels


def breakdown(device: list[Record], host: list[Record], window: Record,
              top: int = 10) -> dict:
    """``{"device_ops": [[name, seconds], ...], "idle_gaps": [[label,
    seconds], ...]}``: the device records' time summed by name, and the
    idle time summed by what the host was doing, each the ``top`` largest."""
    ops: dict[str, float] = defaultdict(float)
    for r in device:
        ops[r.name[:_NAME_CHARS]] += (r.end - r.start) / 1e6
    gaps = idle_gaps(device, window)
    idle: dict[str, float] = defaultdict(float)
    for label, (s, e) in zip(_label_gaps(gaps, host), sorted(gaps)):
        idle[label] += (e - s) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
