"""The 99th percentile of the host-clock latency of every call of the
window, from the call to the end of the synchronise after it, in ms."""

from perfbench.harness.stats import percentile


def value(rec: dict) -> float:
    return percentile(rec["latency_s"], 99) * 1e3
