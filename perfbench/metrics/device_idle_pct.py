"""The share of the traced stretch in which no device record ran, in
percent."""

from perfbench.harness.trace import busy_seconds


def value(rec: dict) -> float | None:
    if "device" not in rec or not rec["device"]:
        return None
    w = rec["trace_window"]
    length = (w.end - w.start) / 1e6
    return 100.0 * (1.0 - busy_seconds(rec["device"], w) / length)
