"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's H100 SXM data sheet,
3.35 TB/s of HBM3 at the 700 W limit."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12},
}


def peak(kind: str, what: str) -> float | None:
    """The card's published peak ``what``, or None for a card not listed."""
    return PEAKS.get(kind, {}).get(what)
