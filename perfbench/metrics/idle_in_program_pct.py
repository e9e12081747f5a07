"""The share of the traced stretch in which no device record runs while
one of the port's ``ia.`` spans is open, in percent: the part of
``device_idle_pct`` that lies inside the port's own calls."""

from perfbench.harness.spans import idle_in_program_us, program_spans


def value(rec: dict) -> float | None:
    spans = program_spans(rec.get("host") or [])
    if not spans or not rec.get("device"):
        return None
    w = rec["trace_window"]
    return 100.0 * idle_in_program_us(rec["device"], spans, w) / (w.end - w.start)
