"""Images completed in the window over the window's length (host clock)."""


def value(rec: dict) -> float:
    return rec["images"] / rec["window_s"]
