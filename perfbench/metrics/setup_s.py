"""Seconds from the process's start to the first timed call: imports, the
CUDA context, the kernels' build or load, the inputs made on the card and
the warm-up calls."""


def value(rec: dict) -> float:
    return rec["setup_s"]
