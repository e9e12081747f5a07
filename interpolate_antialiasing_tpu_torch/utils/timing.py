"""CUDA-event timing of calls on the card."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["time_cuda"]


def time_cuda(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn(*args)`` on the current CUDA stream.

    Runs ``warmup`` untimed calls, then ``iters`` calls between two CUDA
    events, and returns the elapsed device time over ``iters``.  The calls
    are enqueued back to back, so the number is the device's time per call
    as long as the host enqueues faster than the device runs.  Raises when
    CUDA is not available: there is no host-clock fallback.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
