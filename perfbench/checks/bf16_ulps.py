"""The comparison of bfloat16 frames with a float64 reference, in units in
the last place of bfloat16.

A compared output is a bfloat16 batch of frames ``[N, C, H, W]``; the
reference gives each element's exact value in float64, of the same shape,
or several readings of it stacked (``[k, N, C, H, W]``), of which an
element takes the one nearest it.  Two numbers:

* ``ulp_gap``: the largest ``|out - r| / ulp(r)``, where ``ulp(r)`` is the
  spacing of bfloat16 at ``|r|`` (the subnormal spacing, 2**-133, below
  the smallest normal number).  NaN and infinity read infinite.  A route
  that sums in float32 and rounds once to nearest reads at most 0.5 plus
  its float32 error; an element rounded the wrong way away from a tie, or
  a band of rows an ulp off, reads above it.
* ``mismatch_pct``: for each frame, the share of its elements that are not
  the round-to-nearest-even bfloat16 of the reading (an element agrees
  where any reading rounds to it); the worst frame's share, in percent.
  A sound route flips only elements within its float32 error of a tie; a
  bfloat16 intermediate, bfloat16 weights or a truncating store flip tens
  of percent, and a missing or repeated frame nearly all of one.

An output that is not a bfloat16 tensor of the reference's shape reads
``mismatch_pct`` 100 and ``ulp_gap`` infinite.  Frames are compared one at
a time, so the float64 temporaries stay the size of one frame.
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("mismatch_pct", "ulp_gap")

_MANTISSA_BITS = 7  # bfloat16's explicit significand bits
_BIAS = 1023  # float64's exponent bias
_SUBNORMAL_EXP = -133  # bfloat16's subnormal spacing: 2**(-126 - 7)


def ulp(r: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 at ``|r|`` (float64): ``2**(floor(log2 |r|)
    - 7)``, and ``2**-133`` below ``2**-126`` and at 0; built from the
    exponent bits, so exactly a power of two."""
    exp = (r.to(torch.float64).contiguous().view(torch.int64) >> 52) & 0x7FF
    exp = (exp - _MANTISSA_BITS).clamp(min=_BIAS + _SUBNORMAL_EXP)
    return (exp << 52).view(torch.float64)


def round_bf16(r: torch.Tensor) -> torch.Tensor:
    """The round-to-nearest-even bfloat16 of float64 ``r``, in float64, in
    one rounding (a cast through float32 would round twice)."""
    u = ulp(r)
    return torch.round(r / u) * u  # torch.round takes halves to even


def compare(out, ref: torch.Tensor, entry=None) -> dict:
    """``{"mismatch_pct", "ulp_gap"}`` of one bfloat16 output batch ``out``
    against the reference's exact values ``ref`` (float64 ``[N, C, H, W]``
    as ``out``, or several readings stacked: ``[k, N, C, H, W]``).  The
    check reads nothing of the entry."""
    refs = ref if ref.dim() == 5 else ref[None]  # [readings, N, C, H, W]
    if (not isinstance(out, torch.Tensor) or out.dtype != torch.bfloat16
            or tuple(out.shape) != tuple(refs.shape[1:])):
        return {"mismatch_pct": 100.0, "ulp_gap": math.inf}
    worst_pct, gap = 0.0, 0.0
    for n in range(out.shape[0]):
        r = refs[:, n].to(torch.float64)
        o = out[n].to(device=r.device, dtype=torch.float64)[None]
        off = ((o - r).abs() / ulp(r)).amin(0)
        agree = (o == round_bf16(r)).any(0)  # NaN agrees with nothing
        worst_pct = max(worst_pct, float((~agree).to(torch.float64).mean()) * 100.0)
        gap = max(gap, float(torch.nan_to_num(off, nan=math.inf).max()))
    return {"mismatch_pct": worst_pct, "ulp_gap": gap}
