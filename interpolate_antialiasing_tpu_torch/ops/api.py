"""Reference-surface shims (the port of ``interpolate_antialiasing_tpu.ops.api``).

``linear_forward`` / ``nearest_forward`` / ``cubic_forward`` and their
``*_backward`` counterparts, on NCHW float tensors with ``antialias=True``,
as the reference's extension exports them.  Each backward is the exact
adjoint of its antialiased forward (the transposed banded contraction, per
axis: H first, then W), on the same routes as autograd's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config import default_backend
from .resize import _transpose_axis, resize_plane
from .weights import make_axis_spec

__all__ = [
    "linear_forward",
    "nearest_forward",
    "cubic_forward",
    "linear_backward",
    "nearest_backward",
    "cubic_backward",
]


def _forward(x: torch.Tensor, size: Sequence[int], align_corners: bool,
             mode: str) -> torch.Tensor:
    if x.ndim != 4:
        raise ValueError("expected NCHW input")
    return resize_plane(
        x,
        (int(size[0]), int(size[1])),
        h_axis=2,
        w_axis=3,
        mode=mode,
        antialias=True,
        align_corners=align_corners,
    )


def linear_forward(x, size, align_corners: bool = False):
    return _forward(x, size, align_corners, "bilinear")


def nearest_forward(x, size, align_corners: bool = False):
    return _forward(x, size, align_corners, "nearest")


def cubic_forward(x, size, align_corners: bool = False):
    return _forward(x, size, align_corners, "bicubic")


def _backward(grad_output: torch.Tensor, osize, input_shape, align_corners,
              mode) -> torch.Tensor:
    """Grad with respect to the input of the antialiased forward: the
    transposed band per axis.  ``input_shape`` is the full NCHW shape, like
    the reference's ``input_size`` argument."""
    g = torch.as_tensor(grad_output)
    if g.ndim != 4:
        raise ValueError("expected NCHW grad_output")
    ih, iw = int(input_shape[2]), int(input_shape[3])
    oh, ow = int(osize[0]), int(osize[1])
    spec_h = make_axis_spec(ih, oh, mode, True, align_corners)
    spec_w = make_axis_spec(iw, ow, mode, True, align_corners)
    backend = default_backend()
    gh = _transpose_axis(g, spec_h, 2, backend)
    return _transpose_axis(gh, spec_w, 3, backend)


def linear_backward(grad_output, osize, input_shape, align_corners: bool = False):
    return _backward(grad_output, osize, input_shape, align_corners, "bilinear")


def nearest_backward(grad_output, osize, input_shape, align_corners: bool = False):
    return _backward(grad_output, osize, input_shape, align_corners, "nearest")


def cubic_backward(grad_output, osize, input_shape, align_corners: bool = False):
    return _backward(grad_output, osize, input_shape, align_corners, "bicubic")
