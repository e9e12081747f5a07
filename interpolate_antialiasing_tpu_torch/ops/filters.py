"""Continuous reconstruction filters for antialiased resampling.

These are the same filter family Pillow's ``ImagingResample`` uses and that the
reference exposes through its ``HelperInterp{Linear,Nearest,Cubic}`` structs
(reference: step_two_dot_two/aa_interpolation_impl.h:292-300, 367-372, 410-424).

Each filter is described by

  * ``support`` — half-width of the kernel's support in *source* pixels when no
    antialiasing widening is applied (bilinear: 1, box: 0.5, cubic: 2), and
  * a vectorised evaluation function ``f(x, xp)`` valid for any array ``x``
    of the array namespace ``xp``, with ``f(x) == 0`` for ``|x| >= support``.

A copy of ``interpolate_antialiasing_tpu.ops.filters`` (numpy only, so it
imports no jax): the port evaluates the filters on the host in float64 with
``xp=numpy``, exactly like the JAX package's table builders, so both packages
build identical weight tables.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

__all__ = [
    "Filter",
    "FILTERS",
    "get_filter",
    "filter_is_nonnegative",
    "triangle_filter",
    "box_filter",
    "keys_cubic_filter",
    "lanczos3_filter",
    "hamming_filter",
]


@dataclasses.dataclass(frozen=True)
class Filter:
    """A continuous resampling filter.

    ``support`` matches the reference's ``interp_size * 0.5``: the reference
    stores ``interp_size`` (2 for linear, 1 for nearest/box, 4 for cubic) and
    derives ``support = interp_size * 0.5`` (optionally scaled for AA); we
    store the support directly.
    """

    name: str
    support: float

    def __call__(self, x, xp) -> Any:
        raise NotImplementedError

    @property
    def interp_size(self) -> int:
        """The reference's base ``interp_size`` (= 2 * support)."""
        return int(round(2 * self.support))


@dataclasses.dataclass(frozen=True)
class _FnFilter(Filter):
    fn: Callable[[Any, Any], Any] = None  # type: ignore[assignment]

    def __call__(self, x, xp):
        return self.fn(x, xp)


def triangle_filter(x, xp):
    """Triangle / tent filter: the 'bilinear' kernel.

    max(0, 1 - |x|); Pillow's ``bilinear_filter``
    (reference: step_two_dot_two/aa_interpolation_impl.h:292-300).
    """
    ax = xp.abs(x)
    return xp.where(ax < 1.0, 1.0 - ax, xp.zeros_like(ax))


def box_filter(x, xp):
    """Box filter: Pillow's NEAREST-ish 'box' kernel.

    1 on (-0.5, 0.5], else 0
    (reference: step_two_dot_two/aa_interpolation_impl.h:367-372).
    """
    one = xp.ones_like(x)
    zero = xp.zeros_like(x)
    return xp.where((x > -0.5) & (x <= 0.5), one, zero)


def _keys_cubic(x, xp, a):
    ax = xp.abs(x)
    inner = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    outer = ((ax - 5.0) * ax + 8.0) * ax - 4.0
    outer = outer * a
    return xp.where(ax < 1.0, inner, xp.where(ax < 2.0, outer, xp.zeros_like(ax)))


def keys_cubic_filter(x, xp):
    """Keys bicubic kernel with a = -0.5 (Catmull-Rom family).

    Pillow's ``bicubic_filter``
    (reference: step_two_dot_two/aa_interpolation_impl.h:410-424).
    """
    return _keys_cubic(x, xp, -0.5)


def keys_cubic_075_filter(x, xp):
    """Keys bicubic with a = -0.75: the classic (non-antialiased) torch/
    OpenCV convention (ATen ``cubic_convolution1``).  Used for the
    ``antialias=False`` bicubic path only."""
    return _keys_cubic(x, xp, -0.75)


def hamming_filter(x, xp):
    """Hamming-windowed sinc, support 1 (Pillow's HAMMING):
    sinc(x) * (0.54 + 0.46 cos(pi x)) on |x| < 1.

    Pillow's Resample.c writes the window constants as FLOAT literals
    (0.54f/0.46f); using exact doubles flips ~25% of fixed-point
    coefficients by one ULP and breaks byte parity, so the float32-rounded
    values are used here (verified across randomised size sweeps)."""
    ax = xp.abs(x)
    val = xp.sinc(x) * (0.5400000214576721 + 0.46000000834465027 * xp.cos(xp.pi * x))
    # Pillow returns exactly 1.0 at x == 0 (the float constants sum to
    # 1.0000000298..., so the windowed form must not be used there).
    val = xp.where(ax == 0.0, xp.ones_like(val), val)
    return xp.where(ax < 1.0, val, xp.zeros_like(ax))


def lanczos3_filter(x, xp):
    """Lanczos-3 windowed sinc (Pillow's LANCZOS). Extension beyond the
    reference's three filters; same table machinery applies."""
    ax = xp.abs(x)
    # sinc(x) * sinc(x/3) on |x| < 3. numpy.sinc is the normalized sinc.
    val = xp.sinc(x) * xp.sinc(x / 3.0)
    return xp.where(ax < 3.0, val, xp.zeros_like(ax))


def lanczos5_filter(x, xp):
    """Lanczos-5 windowed sinc (jax.image.resize's 'lanczos5'; no Pillow
    counterpart — PIL LANCZOS is lanczos3). Completes the jax.image
    method set for the image_resize drop-in."""
    ax = xp.abs(x)
    val = xp.sinc(x) * xp.sinc(x / 5.0)
    return xp.where(ax < 5.0, val, xp.zeros_like(ax))


FILTERS: dict[str, Filter] = {
    "bilinear": _FnFilter("bilinear", 1.0, fn=triangle_filter),
    "linear": _FnFilter("linear", 1.0, fn=triangle_filter),
    "triangle": _FnFilter("triangle", 1.0, fn=triangle_filter),
    "nearest": _FnFilter("nearest", 0.5, fn=box_filter),
    "box": _FnFilter("box", 0.5, fn=box_filter),
    "bicubic": _FnFilter("bicubic", 2.0, fn=keys_cubic_filter),
    "cubic": _FnFilter("cubic", 2.0, fn=keys_cubic_filter),
    "bicubic075": _FnFilter("bicubic075", 2.0, fn=keys_cubic_075_filter),
    "lanczos3": _FnFilter("lanczos3", 3.0, fn=lanczos3_filter),
    "lanczos5": _FnFilter("lanczos5", 5.0, fn=lanczos5_filter),
    "hamming": _FnFilter("hamming", 1.0, fn=hamming_filter),
    # jax.image.resize's names for the linear/cubic kernels on volumes —
    # same filters, so the image_resize drop-in accepts the full
    # jax.image method vocabulary
    "trilinear": _FnFilter("trilinear", 1.0, fn=triangle_filter),
    "tricubic": _FnFilter("tricubic", 2.0, fn=keys_cubic_filter),
}

# Every registry name for the Keys cubic kernel.  The classic (non-AA)
# path swaps these for the a=-0.75 variant (torch/OpenCV convention) —
# ONE list, imported by every dispatch site, so a new cubic alias cannot
# silently keep PIL's a=-0.5 on the classic path (the same single-source
# rule the clip-eligibility and MXU cost-model constants follow).
CUBIC_NAMES = tuple(
    name for name, f in FILTERS.items() if f.fn is keys_cubic_filter
)


@functools.cache
def filter_is_nonnegative(name: str) -> bool:
    """Whether the filter is non-negative everywhere on its support.

    Derived from the filter FUNCTION (dense sampling over the support),
    never from a hand-maintained mode list — the classifier perf gates key
    quantised-intermediate / clip-free optimisations on (the same drift
    class pil_exact._needs_clip closed for the digit kernels: adding a
    filter, or a future near-negative window, must route conservatively by
    construction).  Non-negative rows keep intermediate quantisation error
    bounded by sum(w)*0.5 = 0.5; a negative lobe has sum|w| > 1 and can
    amplify it past the ±1 uint8 gate.
    """
    import numpy as np

    f = get_filter(name)
    xs = np.linspace(-f.support - 0.5, f.support + 0.5, 1 << 14)
    return bool(np.min(f(xs, np)) >= 0.0)


def get_filter(name: str) -> Filter:
    try:
        return FILTERS[name]
    except KeyError:
        raise ValueError(
            f"unknown filter {name!r}; available: {sorted(FILTERS)}"
        ) from None
