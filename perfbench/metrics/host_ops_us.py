"""Self time of the port's ``ia.ops.*`` spans (routing and checks of
``resize``, ``resize_pil_exact``, ``crop_and_resize`` and the windowed
crop, the dense route's products included) per traced call, in
microseconds."""

from perfbench.harness.spans import layer_us_per_call


def value(rec: dict) -> float | None:
    return layer_us_per_call(rec, "ops")
