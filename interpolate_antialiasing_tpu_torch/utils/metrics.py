"""Accuracy metrics used by the parity harness (a numpy-only copy of
``interpolate_antialiasing_tpu.utils.metrics``).

Rebuild of the reference's MAE / MaxAbsE printout and hard gates
(reference: test.py:360-379).
"""

from __future__ import annotations

import numpy as np

__all__ = ["mae", "max_abs_err", "accuracy_report"]


def mae(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).mean())


def max_abs_err(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max())


def accuracy_report(result, oracle, label: str = "") -> dict:
    return {
        "label": label,
        "mae": mae(result, oracle),
        "max_abs_err": max_abs_err(result, oracle),
    }
