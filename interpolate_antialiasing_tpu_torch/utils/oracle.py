"""Pillow ground truth: the executable spec of antialiased resize (a copy of
``interpolate_antialiasing_tpu.utils.oracle``).

``PIL.Image.resize`` is the oracle of the uint8 routes.  Pillow is imported
here only, and only where it is installed: no route of the package needs it,
and the card's machine may lack it (:func:`pil_available`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pil_resize", "pil_available"]

try:  # pragma: no cover - availability probe
    from PIL import Image

    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


def pil_available() -> bool:
    return _HAVE_PIL


_PIL_FILTERS = None


def _pil_filter(mode: str):
    global _PIL_FILTERS
    if _PIL_FILTERS is None:
        _PIL_FILTERS = {
            "bilinear": Image.BILINEAR,
            "linear": Image.BILINEAR,
            "triangle": Image.BILINEAR,
            "bicubic": Image.BICUBIC,
            "cubic": Image.BICUBIC,
            "box": Image.BOX,
            "nearest": Image.BOX,  # the reference's "nearest" is PIL's box AA filter
            "lanczos3": Image.LANCZOS,
            "hamming": Image.HAMMING,
            "pil_nearest": Image.NEAREST,
        }
    return _PIL_FILTERS[mode]


def pil_resize(chw_or_hw: np.ndarray, out_hw: tuple[int, int], mode: str) -> np.ndarray:
    """Resize with Pillow.  Input: uint8 HW or CHW array; returns same layout.

    ``out_hw`` is (height, width) — note PIL.Image.resize takes (width, height).
    Raises RuntimeError where Pillow is not installed.
    """
    if not _HAVE_PIL:
        raise RuntimeError("Pillow not available")
    arr = np.asarray(chw_or_hw)
    oh, ow = out_hw
    filt = _pil_filter(mode)
    if arr.ndim == 2:
        return np.asarray(Image.fromarray(arr).resize((ow, oh), filt))
    if arr.ndim == 3 and arr.shape[0] in (1, 3, 4):
        hwc = np.transpose(arr, (1, 2, 0))
        if hwc.shape[-1] == 1:
            out = np.asarray(Image.fromarray(hwc[..., 0]).resize((ow, oh), filt))[
                ..., None
            ]
        else:
            out = np.asarray(Image.fromarray(hwc).resize((ow, oh), filt))
        return np.transpose(out, (2, 0, 1))
    raise ValueError(f"unsupported shape {arr.shape}")
