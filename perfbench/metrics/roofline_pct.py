"""The traced calls' essential bytes (each input byte they need read once,
each output byte written once, counted from shapes and boxes by the entry's
adapter) at the card's published bandwidth, as a share of their device
time, in percent."""

from perfbench.harness.trace import device_seconds


def value(rec: dict) -> float | None:
    if "device" not in rec or not rec["device"] or not rec.get("peak_bytes_per_s"):
        return None
    busy = device_seconds(rec["device"])
    if busy <= 0:
        return None
    return 100.0 * rec["essential_bytes"] / rec["peak_bytes_per_s"] / busy
