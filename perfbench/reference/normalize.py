"""torchvision's ``ToTensor`` then ``Normalize(mean, std)`` of uint8 grey
levels, in float64 (or in a lower ``dtype``, for the control)."""

from __future__ import annotations

import torch


def normalize(levels: torch.Tensor, mean, std, dtype=torch.float64) -> torch.Tensor:
    """``(levels / 255 - mean) / std`` per channel (dim -3), in ``dtype``."""
    shape = (-1, 1, 1)
    m = torch.tensor(mean, dtype=dtype, device=levels.device).reshape(shape)
    s = torch.tensor(std, dtype=dtype, device=levels.device).reshape(shape)
    return (levels.to(dtype) / 255 - m) / s


def levels_of(out: torch.Tensor, mean, std) -> torch.Tensor:
    """The grey levels that normalised values ``out`` stand for: the
    inverse of :func:`normalize` in float64, rounded to the nearest
    integer."""
    shape = (-1, 1, 1)
    m = torch.tensor(mean, dtype=torch.float64, device=out.device).reshape(shape)
    s = torch.tensor(std, dtype=torch.float64, device=out.device).reshape(shape)
    return torch.round((out.to(torch.float64) * s + m) * 255)
