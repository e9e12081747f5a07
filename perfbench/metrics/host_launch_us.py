"""Duration of the port's ``ia.native.*`` spans (each launch of a
hand-written kernel through ctypes, from its stream lookup to its error
check) per traced call, in microseconds."""

from perfbench.harness.spans import layer_us_per_call


def value(rec: dict) -> float | None:
    return layer_us_per_call(rec, "native")
