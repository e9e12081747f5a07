"""Self time of the port's ``ia.models.*`` spans (the pipelines: sizes,
the centre crop's view, the normalisation's operators) per traced call, in
microseconds."""

from perfbench.harness.spans import layer_us_per_call


def value(rec: dict) -> float | None:
    return layer_us_per_call(rec, "models")
