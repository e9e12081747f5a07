"""A closed loop with one caller and one call in flight: each call is
synchronised before the next is issued, as a loader does that hands each
batch over complete."""

from __future__ import annotations

import sys
import time
import traceback


def run(call, seconds: float, sync, on_done, in_flight: int = 1) -> dict:
    """Calls ``call(i)`` for ``i = 0, 1, ...`` until ``seconds`` have passed
    since the first call began, each followed by ``sync()``.  Returns the
    host-clock latency of each call (call to the end of its ``sync``), its
    enqueue time (call to return), the window's start and end, and the
    calls that raised.  ``on_done(i, output)`` sees each completed call."""
    if in_flight != 1:
        raise ValueError(f"the closed loop keeps one call in flight, not {in_flight}")
    clock = time.perf_counter
    latency, enqueue, failed = [], [], []
    start = clock()
    deadline = start + seconds
    i = 0
    while True:
        t0 = clock()
        try:
            out = call(i)
            t1 = clock()
            sync()
        except Exception:  # noqa: BLE001 -- a failed call is counted, the loop goes on
            if not failed:
                traceback.print_exc(file=sys.stderr)
            failed.append(i)
            out, t1 = None, clock()
        t2 = clock()
        latency.append(t2 - t0)
        enqueue.append(t1 - t0)
        if out is not None:
            on_done(i, out)
        i += 1
        if t2 >= deadline:
            break
    return {"latency_s": latency, "enqueue_s": enqueue, "start": start, "end": t2,
            "calls": i, "failed_calls": failed}
