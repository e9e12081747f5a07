"""Antialiased bilinear downscale of frames, in plain torch and float64,
from the PIL / torchvision definition: the triangle filter with its
support widened by the scale (``in / out`` where that is above 1), the
taps whose centres fall inside the support, and each output's weights
divided by their sum.  The weights are :func:`perfbench.reference.crop.band`
over the whole axis (the box ``[0, size)``).

At exactly 2x the inner weights are 1/8, 3/8, 3/8, 1/8 (the triangle's
1/4, 3/4, 3/4, 1/4 over their sum, 2), and the edge rows' 3/7, 3/7, 1/7
(the first row; the last mirrored): the tap past the edge is left out and
the other three divided by their sum, 7/4.

Each frame is ``B_h . x . B_w^T`` in float64, on the device the frames are
on.  The reference is exact (float64's error is some 2**-45 of a bfloat16
unit in the last place); only the one rounding to bfloat16 is the port's.
"""

from __future__ import annotations

import torch

from perfbench.reference.crop import band


def bands(size: int, out_size: int, device, method: str = "bilinear") -> torch.Tensor:
    """``[out_size, size]`` float64 weights of one axis, each row summing
    to 1."""
    zero = torch.zeros(1, dtype=torch.float64, device=device)
    return band(zero, zero + size, size, out_size, method)[0]


def downscale(x: torch.Tensor, oh: int, ow: int, method: str = "bilinear") -> torch.Tensor:
    """Float64 ``[N, C, oh, ow]`` of frames ``x [N, C, H, W]`` (any float
    dtype), frame by frame, so the float64 temporaries stay the size of
    one frame."""
    N, C, H, W = x.shape
    bh = bands(H, oh, x.device, method)
    bw_t = bands(W, ow, x.device, method).T
    out = torch.empty((N, C, oh, ow), dtype=torch.float64, device=x.device)
    for n in range(N):
        out[n] = bh @ x[n].to(torch.float64) @ bw_t
    return out
