"""``AAResize``: the antialiased resize as a parameter-free ``nn.Module``
(the port of ``interpolate_antialiasing_tpu.models.flax_module``, the flax
wrapper).  Differentiable inside larger models: its backward is the exact
adjoint of the resize."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import _axes_for, resize_plane

__all__ = ["AAResize"]


class AAResize(nn.Module):
    """Resize the ``(H, W)`` plane of a float tensor in ``data_format``
    layout to ``out_hw``."""

    def __init__(self, out_hw: tuple[int, int], method: str = "bilinear",
                 antialias: bool = True, data_format: str = "NCHW"):
        super().__init__()
        self.out_hw = tuple(out_hw)
        self.method = method
        self.antialias = antialias
        self.data_format = data_format

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h_axis, w_axis = _axes_for(x, self.data_format)
        return resize_plane(x, self.out_hw, h_axis % x.ndim, w_axis % x.ndim,
                            mode=self.method, antialias=self.antialias)
