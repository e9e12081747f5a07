"""Mean host microseconds per call from the entry call to its return (the
port's checks, plans, tables and launches), over the window's calls, which
the profiler does not cover."""


def value(rec: dict) -> float:
    return sum(rec["enqueue_s"]) / len(rec["enqueue_s"]) * 1e6
