"""Antialiased image pyramids (mip chains) built from the resize op (the
port of ``interpolate_antialiasing_tpu.models.pyramid``)."""

from __future__ import annotations

import torch

from ..ops.resize import resize_plane

__all__ = ["aa_pyramid"]


def aa_pyramid(
    x: torch.Tensor,
    levels: int,
    mode: str = "bilinear",
    factor: int = 2,
    h_axis: int = -2,
    w_axis: int = -1,
) -> list[torch.Tensor]:
    """Return ``[x, down(x), down(down(x)), ...]`` with ``levels`` entries.

    Each level is an antialiased ``1/factor`` downsample of the previous
    (:func:`..ops.resize.resize_plane`: kernel A on the card for a trailing
    ``[H, W]`` plane, differentiable).
    """
    out = [x]
    for _ in range(levels - 1):
        h = max(1, out[-1].shape[h_axis] // factor)
        w = max(1, out[-1].shape[w_axis] // factor)
        out.append(
            resize_plane(out[-1], (h, w), h_axis=h_axis, w_axis=w_axis, mode=mode)
        )
    return out
