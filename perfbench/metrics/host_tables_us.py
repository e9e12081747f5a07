"""Self time of the port's ``ia.tables.*`` and ``ia.build.*`` spans (host
tables, plans, their uploads and the table launches' set-up) per traced
call, in microseconds."""

from perfbench.harness.spans import layer_us_per_call


def value(rec: dict) -> float | None:
    return layer_us_per_call(rec, "tables")
