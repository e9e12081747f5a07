"""``jax.image.scale_and_translate`` drop-in (the port of
``interpolate_antialiasing_tpu.ops.scale_translate``).

Axis ``d`` of the output samples the input at ``sample_f = (i + 0.5) /
scale[d] - translation[d] / scale[d] - 0.5`` through an antialiased
kernel.  That is the span machinery — ``center = lo + (i + 0.5) * (1 /
scale)`` with ``lo = -translation / scale`` — so Python or NumPy affine
parameters over two spatial dims route through
:func:`..weights.make_affine_axis_spec` onto the differentiable plane op
(kernel A and its exact adjoint on the card, forward mode and vmap), while
tensor parameters, the counterpart of JAX's traced ones, and 1 or 3+
spatial dims run a dense weight contraction with the identical formulas,
differentiable in the image, the scale and the translation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import full_f32
from .filters import get_filter
from .weights import make_affine_axis_spec

__all__ = ["scale_and_translate"]

# jax.image.scale_and_translate method vocabulary -> registry names.
# (jax has no box/nearest kernel for this entry point.)
_METHODS = {
    "linear": "linear",
    "bilinear": "linear",
    "trilinear": "linear",
    "triangle": "linear",
    "cubic": "cubic",
    "bicubic": "cubic",
    "tricubic": "cubic",
    "lanczos3": "lanczos3",
    "lanczos5": "lanczos5",
}


def _weight_matrix_dense(in_size: int, out_size: int, zoom: torch.Tensor,
                         translation: torch.Tensor, mode: str, antialias: bool,
                         dtype: torch.dtype) -> torch.Tensor:
    """``[in, out]`` weight matrix — jax.image's compute_weight_mat with the
    library's filter registry, in torch ops (differentiable in ``zoom`` and
    ``translation``).  Handles negative zoom."""
    filt = get_filter(mode)
    inv = 1.0 / zoom
    # jax quirk, reproduced deliberately: kernel_scale = max(inv, 1) on the
    # SIGNED inverse — a negative zoom therefore never widens the kernel
    # (no antialias), even with antialias=True.
    kernel_scale = torch.clamp(inv, min=1.0) if antialias else 1.0
    dev = zoom.device
    i = torch.arange(out_size, dtype=dtype, device=dev)
    sample_f = (i + 0.5) * inv - translation * inv - 0.5
    arg = (sample_f[None, :]
           - torch.arange(in_size, dtype=dtype, device=dev)[:, None]) / kernel_scale
    w = filt(arg, torch).to(dtype)
    total = w.sum(dim=0, keepdim=True)
    ok = total.abs() > 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(ok, w / torch.where(ok, total, torch.ones_like(total)), 0.0)
    in_range = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(in_range[None, :], w, 0.0)


def scale_and_translate(
    image: torch.Tensor,
    shape: Sequence[int],
    spatial_dims: Sequence[int],
    scale,
    translation,
    method: str = "linear",
    antialias: bool = True,
    precision=None,
) -> torch.Tensor:
    """Drop-in for :func:`jax.image.scale_and_translate`.

    Apply an affine (zoom + shift) resampling along ``spatial_dims``:
    output pixel ``i`` of axis ``d`` looks at input coordinate
    ``(i + 0.5)/scale[d] - translation[d]/scale[d] - 0.5``.

    * Python or NumPy ``scale``/``translation`` with exactly two spatial
      dims ride the differentiable plane op (kernel A on the card, the
      exact adjoint backward, forward mode), with negative scales handled
      by axis flips; a zero scale gives zeros.
    * Tensor ``scale`` or ``translation`` (the counterpart of JAX's traced
      parameters), and 1 or 3+ spatial dims, run the dense contraction
      (same formulas; differentiable in the image, the scale and the
      translation).

    ``precision`` is accepted for signature compatibility; every route
    multiplies in full float32 (TF32 off) or float64.
    """
    del precision
    if method not in _METHODS:
        raise ValueError(
            f"unknown method {method!r}; expected one of {sorted(_METHODS)}"
        )
    mode = _METHODS[method]
    shape = tuple(int(s) for s in shape)
    if len(shape) != image.ndim:
        raise ValueError(
            f"shape must have the input rank {image.ndim}, got {len(shape)}"
        )
    spatial_dims = tuple(int(d) % image.ndim for d in spatial_dims)
    n = len(spatial_dims)
    if len(set(spatial_dims)) != n or n == 0:
        raise ValueError(f"spatial_dims must be distinct and non-empty: {spatial_dims}")
    for d in range(image.ndim):
        if d not in spatial_dims and shape[d] != image.shape[d]:
            raise ValueError(
                f"non-spatial dim {d}: shape {shape[d]} != input {image.shape[d]}"
            )
    scale_l = list(scale) if not hasattr(scale, "shape") else [scale[k] for k in range(n)]
    trans_l = (
        list(translation)
        if not hasattr(translation, "shape")
        else [translation[k] for k in range(n)]
    )
    if len(scale_l) != n or len(trans_l) != n:
        raise ValueError(
            f"scale/translation must have one entry per spatial dim ({n})"
        )
    if not image.is_floating_point():
        image = image.to(torch.float32)

    static = not any(isinstance(v, torch.Tensor) for v in (*scale_l, *trans_l))
    if static and n == 2:
        h_axis, w_axis = spatial_dims
        x = image
        specs = []
        for axis, s, t in zip(spatial_dims, scale_l, trans_l):
            s = float(np.asarray(s))
            t = float(np.asarray(t))
            if s == 0.0:
                # jax zeroes every sample (sample_f = +-inf is out of range)
                return torch.zeros(shape, dtype=image.dtype, device=image.device)
            aa = antialias
            if s < 0.0:
                # flip identity: resampling with (s, t) equals resampling the
                # flipped axis with (|s|, t - |s| * in_size) (even kernels).
                # jax's kernel_scale = max(1/s, 1) is SIGNED, so a negative
                # zoom never widens the kernel — mirror that by disabling
                # antialias widening on the flipped axis.
                x = torch.flip(x, (axis,))
                s = -s
                t = t - s * x.shape[axis]
                aa = False
            specs.append(make_affine_axis_spec(x.shape[axis], shape[axis], s, t, mode, aa))
        from .resize import resize_plane_vjp

        spec_h, spec_w = specs
        return resize_plane_vjp(x, spec_h, spec_w, h_axis, w_axis, "auto").to(image.dtype)

    # Tensor parameters / N-D: dense per-axis contractions, differentiable.
    cdt = torch.float64 if image.dtype == torch.float64 else torch.float32
    y = image.to(cdt)
    for axis, s, t in zip(spatial_dims, scale_l, trans_l):
        W = _weight_matrix_dense(
            y.shape[axis], shape[axis],
            torch.as_tensor(s, dtype=cdt, device=image.device),
            torch.as_tensor(t, dtype=cdt, device=image.device),
            mode, antialias, cdt,
        )
        with full_f32():
            y = torch.movedim(torch.movedim(y, axis, -1) @ W, -1, axis)
    return y.to(image.dtype)
