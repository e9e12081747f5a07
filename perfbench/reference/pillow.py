"""Pillow's 8-bit antialiased resample, written again from its C source
(``src/libImaging/Resample.c``: ``precompute_coeffs``,
``normalize_coeffs_8bpc``, ``ImagingResampleHorizontal_8bpc`` /
``Vertical_8bpc``, ``ImagingResampleInner``) in numpy and plain torch.

The coefficients are float64 in Pillow's own order of operations, then
rounded half away from zero onto ``2**bits`` (Pillow: ``bits = 22``).  A
pass sums ``pixel * k`` in integers from ``2**(bits - 1)`` and keeps
``clip8(sum >> bits)``.  The horizontal pass runs first and writes a uint8
image, the vertical pass reads it.  Each pass is one float64 matrix
product of integer-valued matrices: every product and partial sum stays
below ``2**53``, so the sums are exact in any order.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

PRECISION_BITS = 22  # 32 - 8 - 2 in Resample.c


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# name -> (support, filter) as Resample.c's ``filters``
FILTERS = {"bilinear": (1.0, _bilinear)}


def coeffs(in_size: int, out_size: int, method: str = "bilinear",
           bits: int = PRECISION_BITS):
    """``(xmin [out] int64, xsize [out] int64, k [out, ksize] int64)``: the
    first input index, the tap count and the fixed-point weights of each
    output index of a resize of the whole axis."""
    support0, filt = FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    # (int) casts truncate toward zero; negatives clamp to 0 either way
    xmin = np.maximum(np.trunc(center - support + 0.5), 0.0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), float(in_size)).astype(np.int64)
    xsize = xmax - xmin
    x = np.arange(ksize, dtype=np.float64)[None, :]
    w = filt((x + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(x < xsize[:, None], w, 0.0)
    ww = np.zeros(out_size, dtype=np.float64)
    for j in range(ksize):  # Pillow's order of the sum
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * float(1 << bits)
    k = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, xsize, k


@functools.lru_cache(maxsize=16)
def int_matrix(in_size: int, out_size: int, method: str = "bilinear",
               bits: int = PRECISION_BITS) -> np.ndarray:
    """The dense ``[out, in]`` matrix of :func:`coeffs`, integer-valued
    float64 (cached: callers do not write to it)."""
    xmin, xsize, k = coeffs(in_size, out_size, method, bits)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        m[o, xmin[o]:xmin[o] + xsize[o]] = k[o, :xsize[o]]
    return m


def _clip8(acc: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.clamp(torch.floor(acc / float(1 << bits)), 0.0, 255.0)


def resize(x: torch.Tensor, out_h: int, out_w: int, method: str = "bilinear",
           bits: int = PRECISION_BITS) -> torch.Tensor:
    """``PIL.Image.resize((out_w, out_h), method)`` of each ``[H, W]`` plane
    of ``x`` (``[..., H, W]``, uint8 values in any dtype): the grey levels
    as float64.  A pass runs only where its axis changes size, as in
    Pillow."""
    H, W = x.shape[-2:]
    dev = x.device
    y = x.to(torch.float64)
    half = float(1 << (bits - 1))
    if W != out_w:
        kw = torch.from_numpy(int_matrix(W, out_w, method, bits)).to(dev)
        y = _clip8(y @ kw.T + half, bits)
    if H != out_h:
        kh = torch.from_numpy(int_matrix(H, out_h, method, bits)).to(dev)
        y = _clip8(kh @ y + half, bits)
    return y


def kept_input_span(in_size: int, out_size: int, first: int, count: int,
                    method: str = "bilinear") -> int:
    """How many input indices the output indices ``first .. first+count-1``
    of a whole-axis resize read: the essential input of a resize whose
    output is then cropped."""
    xmin, xsize, _ = coeffs(in_size, out_size, method)
    sl = slice(first, first + count)
    return int((xmin[sl] + xsize[sl]).max() - xmin[sl].min())
