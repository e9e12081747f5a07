"""Summed durations of the traced stretch's device records, per call, in
ms."""

from perfbench.harness.trace import device_seconds


def value(rec: dict) -> float | None:
    if "device" not in rec or not rec["device"]:
        return None
    return device_seconds(rec["device"]) / rec["trace_calls"] * 1e3
