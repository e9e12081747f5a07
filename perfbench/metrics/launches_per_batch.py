"""Device records (kernels, copies, fills) per call in the traced stretch:
the median over its calls of the records that start inside a call and
the synchronise after it (the profiler now and then drops a record in a
long stretch; the median does not move for it)."""

import statistics

from perfbench.harness.trace import records_per_call


def value(rec: dict) -> float | None:
    if "device" not in rec or not rec["device"]:
        return None
    return float(statistics.median(records_per_call(rec["device"], rec["host"])))
