"""The comparison of normalised uint8 images with the reference's grey
levels.

A compared output is a batch of normalised images.  Three numbers hold it
against the reference's grey levels (where the reference gives several
readings, stacked, an element agrees with the one nearest it):

* ``mismatch_pct``: for each image, the share of its elements whose grey
  level (the output's value mapped back through the normalisation and
  rounded) is not the reference's; the worst image's share, in percent.
  A wrong byte of the resize or crop, a missing or altered image, a NaN
  and a wrong mean or std all show here.
* ``level_gap``: the largest distance, in grey levels, between an
  element's grey level and the reference's (NaN reads infinite).  A share
  of wrong elements says nothing of how far off they are: a few rows
  holding wrong values pass ``mismatch_pct`` where the route's rounding
  flips leave it room, and fail here.
* ``norm_gap``: over the elements whose grey level agrees, the largest
  distance between the output and the reference's float64 normalisation
  of that level.  It reads the float32 rounding of the normalisation, and
  a normalisation computed in a lower precision.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.normalize import levels_of, normalize

NUMBERS = ("mismatch_pct", "level_gap", "norm_gap")


def compare(out, ref: torch.Tensor, entry) -> dict:
    """``{"mismatch_pct", "level_gap", "norm_gap"}`` of one output batch ``out``
    against the reference's grey levels ``ref`` (float64, ``[N, C, H, W]``
    as ``out``, or several readings of it stacked: ``[k, N, C, H, W]``),
    through the normalisation ``entry.mean``, ``entry.std``."""
    if not isinstance(out, torch.Tensor):
        return {"mismatch_pct": 100.0, "level_gap": math.inf, "norm_gap": math.inf}
    refs = ref if ref.dim() == 5 else ref[None]  # [readings, N, C, H, W]
    if tuple(out.shape) != tuple(refs.shape[1:]):
        return {"mismatch_pct": 100.0, "level_gap": math.inf, "norm_gap": math.inf}
    mean, std = entry.mean, entry.std
    out = out.to(refs.device)
    levels = levels_of(out, mean, std)
    off = (levels[None] - refs).abs().amin(0)
    bad = ~(off == 0)  # NaN counts as bad
    per_image = bad.flatten(1).to(torch.float64).mean(1) * 100.0
    gap = (out.to(torch.float64) - normalize(levels, mean, std)).abs()[~bad]
    return {"mismatch_pct": float(per_image.max()),
            "level_gap": float(torch.nan_to_num(off, nan=math.inf).max()),
            "norm_gap": float(gap.max()) if gap.numel() else 0.0}
