"""Public resize API (the port of ``interpolate_antialiasing_tpu.ops.resize``):
``resize``, ``resize_plane``, ``resize_nd``, ``interpolate`` and
``image_resize``, with the JAX package's names, signatures, argument checks
and layouts.

Routing follows the JAX package's **accelerator** routes on every device:

  * uint8 -> uint8 antialiased ``auto`` calls with Pillow semantics go to
    the byte-exact Pillow route (:func:`..ops.pil_exact.resize_pil_exact`),
    as do ``backend='pil_exact'`` and the resize ``box``;
  * other uint8 calls with ``auto``/``pallas`` and uint8, float32 or
    bfloat16 output, and float32/bfloat16 planes on the trailing ``[H, W]``
    axes, run the two-pass resample2d kernel (:func:`.cuda_resize.resize2d`);
  * every other ``auto``/``pallas`` pass runs the per-axis resample_axis
    kernel (:func:`.cuda_resize.resize_axis`);
  * float64, and ``backend='dense'|'gather'|'banded'|'xla'``, run the JAX
    package's plain (non-kernel) formulations (:mod:`.resize_xla`).

On a CUDA tensor the kernel routes launch the kernels; on a CPU tensor they
run the kernels' plain versions.

Autograd: the float passes are linear, and run as ``torch.autograd.Function``
pairs (:mod:`.autograd`, the port of the JAX package's primitives) whose
backward is the exact adjoint ``W^T``: :func:`_plane_adjoint` and
:func:`_transpose_axis` run the same kernels over transposed tables
(``auto``/``pallas``, float32 and bfloat16) or the plain dense adjoint
(float64 and the ``dense``/``gather``/``banded``/``xla`` backends).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import debug_enabled, default_backend, full_f32
from ..utils.trace import spanned
from .cuda_resize import KERNEL_DTYPES, resize2d, resize_axis
from .pil_exact import _PIL_AUTO_METHODS, resize_pil_exact
from .resize_xla import (
    _dense_on,
    resize_axis_banded,
    resize_axis_dense,
    resize_axis_gather,
)
from .weights import AxisSpec, Tables, adjoint_tables, make_axis_spec

# One 1-D pass: a spec (its forward tables, and the adjoint of those), or a
# pass's tables with its adjoint's tables, ``(tables of W, tables of W^T)``
# (the sharded H pass's per-shard tables).
Pass = AxisSpec | tuple[Tables, Tables]

__all__ = ["resize", "resize_plane", "resize_plane_vjp", "interpolate",
           "resize_nd", "image_resize"]

_BACKENDS = ("auto", "xla", "pallas", "dense", "gather", "banded", "pil_exact")

_FORMATS = {
    "NCHW": (-2, -1),
    "NHWC": (-3, -2),
    "CHW": (-2, -1),
    "HWC": (-3, -2),
    "HW": (-2, -1),
    "channels_first": (-2, -1),
    "channels_last": (-3, -2),
}


# ---------------------------------------------------------------------------
# Backend dispatch for one 1-D pass
# ---------------------------------------------------------------------------


def _pick_method(spec: AxisSpec, backend: str) -> str:
    """The JAX package's ``_pick_method`` on its accelerator, without the
    crossover thresholds that send some ``auto`` passes to a dense matrix
    product there: those were measured on a TPU.  On the card ``auto`` is
    always the resample_axis kernel ('pallas')."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {_BACKENDS}")
    if backend == "pil_exact":
        raise ValueError(
            "backend='pil_exact' is only available through resize() on uint8 "
            "images (it is a whole-pipeline integer emulation, not a per-axis "
            "float pass)"
        )
    if backend in ("dense", "gather", "banded", "pallas"):
        return backend
    if backend == "xla":
        # Dense is exact and fast for small tables; compact gather otherwise.
        return "dense" if spec.in_size * spec.out_size <= (1 << 22) else "gather"
    return "pallas"


def _pick_method_f64(spec: AxisSpec) -> str:
    """float64 route (no kernel takes it): banded for large tables, dense
    for small — the JAX package's threshold."""
    return "banded" if spec.in_size * spec.out_size > (1 << 16) else "dense"


def _apply_tables(x: torch.Tensor, t: Tables, axis: int, backend: str) -> torch.Tensor:
    """One pass given by its tables: the resample_axis kernel under
    ``auto``/``pallas`` for its dtypes, else the dense product of the
    tables' matrix (TF32 off)."""
    if backend in ("auto", "pallas") and x.dtype in KERNEL_DTYPES:
        return resize_axis(x, t, axis)
    W = _dense_on(t, x.dtype, x.device)  # [out, in]
    with full_f32():
        y = torch.matmul(x.movedim(axis, -1), W.T)
    return y.movedim(-1, axis)


def _axis_method(spec: AxisSpec, dtype: torch.dtype, backend: str) -> str:
    """The route of one 1-D pass of ``dtype`` under ``backend``: ``'pallas'``
    (the resample_axis kernel) or the plain ``'dense'``, ``'gather'`` or
    ``'banded'``."""
    if dtype == torch.float64 and backend in ("auto", "xla"):
        return _pick_method_f64(spec)
    method = _pick_method(spec, backend)
    if method == "pallas" and dtype not in KERNEL_DTYPES:
        return "dense" if spec.in_size * spec.out_size <= (1 << 22) else "gather"
    return method


def _apply_axis(x: torch.Tensor, spec: Pass, axis: int,
                backend: str) -> torch.Tensor:
    if isinstance(spec, tuple):
        return _apply_tables(x, spec[0], axis, backend)
    method = _axis_method(spec, x.dtype, backend)
    if method == "pallas":
        return resize_axis(x, spec, axis)
    if debug_enabled():
        print(
            f"[ia-tpu] axis={axis} {spec.in_size}->{spec.out_size} {method} "
            f"ntaps={spec.ntaps} scale={spec.scale:.4f}"
        )
    fn = {
        "dense": resize_axis_dense,
        "gather": resize_axis_gather,
        "banded": resize_axis_banded,
    }[method]
    return fn(x, spec, axis)


def _apply_axis_diff(x: torch.Tensor, spec: AxisSpec, axis: int,
                     backend: str) -> torch.Tensor:
    """One pass as a differentiable op (its backward is
    :func:`_transpose_axis`), on every backend route."""
    from .autograd import apply_axis

    return apply_axis(x, spec, axis, backend)


# ---------------------------------------------------------------------------
# Separable 2-D plane resize
# ---------------------------------------------------------------------------


def _plane_kernel(dtype: torch.dtype, ndim: int, h_axis: int, w_axis: int,
                  backend: str) -> bool:
    """Whether a plane pass runs the two-pass resample2d kernel: a trailing
    ``[H, W]`` plane of a kernel dtype under ``auto``/``pallas`` (the JAX
    package's whole-image and streamed kernels; resize2d covers both sizes);
    else one pass per axis, W then H."""
    return (backend in ("pallas", "auto") and dtype in KERNEL_DTYPES
            and h_axis % ndim == ndim - 2 and w_axis % ndim == ndim - 1)


def _resize_plane_impl(
    x: torch.Tensor, spec_h: AxisSpec, spec_w: AxisSpec, h_axis: int,
    w_axis: int, backend: str
) -> torch.Tensor:
    if _plane_kernel(x.dtype, x.ndim, h_axis, w_axis, backend):
        return resize2d(x, spec_h, spec_w, out_dtype=x.dtype)
    # Same pass order as the reference's separable driver: innermost (W) dim
    # first, then H.
    y = _apply_axis(x, spec_w, w_axis, backend)
    return _apply_axis(y, spec_h, h_axis, backend)


def _transpose_axis(g: torch.Tensor, spec: Pass, axis: int,
                    backend: str) -> torch.Tensor:
    """Apply ``W^T`` along ``axis``: the exact adjoint of :func:`_apply_axis`
    (``g`` has ``spec.out_size`` there, the result ``spec.in_size``).

    ``auto``/``pallas`` with float32 or bfloat16 runs one resample_axis
    launch over the transposed tables (the JAX package's
    ``resize_axis_transpose_pallas``); float64 and the plain backends
    contract with ``dense_matrix(spec).T`` (its einsum), TF32 off.  A pass
    given as ``(tables, adjoint tables)`` runs its adjoint tables."""
    if isinstance(spec, tuple):
        return _apply_tables(g, spec[1], axis, backend)
    if backend in ("auto", "pallas") and g.dtype in (torch.float32, torch.bfloat16):
        if debug_enabled():
            print(f"[ia-tpu] adjoint axis={axis} {spec.out_size}->{spec.in_size} "
                  "resample_axis")
        return resize_axis(g, adjoint_tables(spec), axis)
    W = _dense_on(spec, g.dtype, g.device)  # [out, in]
    with full_f32():
        y = torch.matmul(g.movedim(axis, -1), W)
    return y.movedim(-1, axis)


def _plane_adjoint(g: torch.Tensor, spec_h: AxisSpec, spec_w: AxisSpec,
                   h_axis: int, w_axis: int, backend: str) -> torch.Tensor:
    """Exact adjoint of :func:`_resize_plane_impl`.  A trailing ``[H, W]``
    plane under ``auto``/``pallas`` in float32 or bfloat16 is one resample2d
    launch over the transposed tables, W pass then H pass (the JAX
    package's ``resize2d_onekernel_transpose``); otherwise the per-axis
    adjoints in reverse pass order, H first, then W."""
    if (
        backend in ("auto", "pallas")
        and g.dtype in (torch.float32, torch.bfloat16)
        and h_axis % g.ndim == g.ndim - 2
        and w_axis % g.ndim == g.ndim - 1
    ):
        if debug_enabled():
            print("[ia-tpu] adjoint plane resample2d")
        return resize2d(g, adjoint_tables(spec_h), adjoint_tables(spec_w),
                        out_dtype=g.dtype)
    gh = _transpose_axis(g, spec_h, h_axis, backend)
    return _transpose_axis(gh, spec_w, w_axis, backend)


def resize_plane_vjp(x: torch.Tensor, spec_h: AxisSpec, spec_w: AxisSpec,
                     h_axis: int, w_axis: int, backend: str) -> torch.Tensor:
    """Spec-level plane entry: the differentiable plane op (backward
    :func:`_plane_adjoint`, forward mode and ``torch.func.vmap`` too)."""
    from .autograd import apply_plane

    return apply_plane(x, spec_h, spec_w, h_axis, w_axis, backend)


@spanned("ia.ops.resize_plane")
def resize_plane(
    x: torch.Tensor,
    out_hw: tuple[int, int],
    h_axis: int,
    w_axis: int,
    mode: str = "bilinear",
    antialias: bool = True,
    align_corners: bool = False,
    backend: str | None = None,
    scale_factors: tuple[float, float] | None = None,
    span_h: tuple[float, float] | None = None,
    span_w: tuple[float, float] | None = None,
) -> torch.Tensor:
    """Differentiable separable resize of the (h_axis, w_axis) plane.

    Input must already be a floating dtype; use :func:`resize` for the full
    dtype/layout surface.  Reverse mode (the exact adjoint, any order),
    forward mode (``torch.func.jvp``) and ``torch.func.vmap`` work on every
    backend route.
    """
    backend = backend or default_backend()
    sfh, sfw = scale_factors if scale_factors is not None else (None, None)
    spec_w = make_axis_spec(
        x.shape[w_axis], out_hw[1], mode, antialias, align_corners, sfw,
        span=span_w,
    )
    spec_h = make_axis_spec(
        x.shape[h_axis], out_hw[0], mode, antialias, align_corners, sfh,
        span=span_h,
    )
    return resize_plane_vjp(x, spec_h, spec_w, h_axis, w_axis, backend)


# ---------------------------------------------------------------------------
# Full user-facing entry point
# ---------------------------------------------------------------------------


def _axes_for(x: torch.Tensor, data_format: str | None) -> tuple[int, int]:
    if data_format is None:
        data_format = "HW" if x.ndim == 2 else "NCHW"
    if data_format not in _FORMATS:
        raise ValueError(f"unknown data_format {data_format!r}")
    if x.ndim == 2:
        return x.ndim - 2, x.ndim - 1
    ha, wa = _FORMATS[data_format]
    return x.ndim + ha, x.ndim + wa


def _legacy_nearest_indices(
    in_size: int, out_size: int, scale_factor: float | None = None
) -> np.ndarray:
    """Torch *legacy* nearest source indices: ``min(floor(i * scale), in-1)``
    with the multiply and floor in float32, exactly like ATen's
    ``nn_compute_source_index``.

    Precision quirk reproduced from ATen: the size-driven path computes
    ``i * (in/out)`` in float32, but the scale_factor-driven path computes
    ``i * (1/scale_factor)`` in double.
    """
    if scale_factor is not None and scale_factor > 0:
        idx = np.floor(np.arange(out_size) * (1.0 / scale_factor)).astype(np.int64)
    else:
        scale = np.float32(in_size) / np.float32(out_size)
        i = np.arange(out_size, dtype=np.float32)
        idx = np.floor(i * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1).astype(np.int32)


# unsigned types PyTorch's index_select does not take; they gather as the
# signed type of the same width (the bits move unchanged)
_SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _take(x: torch.Tensor, idx: np.ndarray, axis: int) -> torch.Tensor:
    """``jnp.take(x, idx, axis)`` for host indices, for every dtype."""
    idx_t = torch.from_numpy(idx.astype(np.int64)).to(x.device)
    twin = _SIGNED_TWIN.get(x.dtype)
    if twin is None:
        return x.index_select(axis, idx_t)
    return x.view(twin).index_select(axis, idx_t).view(x.dtype)


def _resize_nearest_legacy(x, oh, ow, h_axis, w_axis, scale_factors):
    sfh, sfw = scale_factors if scale_factors is not None else (None, None)
    y = _take(x, _legacy_nearest_indices(x.shape[h_axis], oh, sfh), h_axis)
    return _take(y, _legacy_nearest_indices(x.shape[w_axis], ow, sfw), w_axis)


def _compute_dtype(in_dtype: torch.dtype) -> torch.dtype:
    """Resampling arithmetic dtype for a given storage dtype.

    float32/float64/bfloat16 compute natively.  Integers of up to 16 bits
    and float16 compute in float32, which holds every such pixel exactly.
    Wider integers compute in float64 — the JAX package's rule under x64
    (its tests run with x64 on; without x64 JAX falls back to float32, a
    fallback the port does not need).
    """
    if in_dtype.is_floating_point:
        return torch.float32 if in_dtype == torch.float16 else in_dtype
    if in_dtype != torch.bool and torch.iinfo(in_dtype).bits > 16:
        return torch.float64
    return torch.float32


def _finalize_dtype(y: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Cast a float resample result back to the requested storage dtype.

    Integer targets get Pillow's rounding convention — ``floor(v + 0.5)``
    clamped to the dtype's range (not ``torch.round``, which rounds half to
    even, and not a truncating cast).  Rounding happens in the arriving
    float dtype (float64 results of the wide-integer rule stay float64).
    Clamp bounds are the widest same-dtype floats inside the target range:
    ``float32(2**31 - 1)`` rounds up to ``2**31``, so the high bound backs
    off to the nearest representable float at or below the dtype max.
    """
    if not out_dtype.is_floating_point and out_dtype != torch.bool:
        info = torch.iinfo(out_dtype)
        fdt = np.float64 if y.dtype == torch.float64 else np.float32
        lo = fdt(info.min)
        if float(lo) < info.min:
            lo = np.nextafter(lo, fdt(0.0))
        hi = fdt(info.max)
        if float(hi) > info.max:
            hi = np.nextafter(hi, fdt(0.0))
        tdt = torch.float64 if fdt is np.float64 else torch.float32
        y = torch.floor(y.to(tdt) + 0.5).clamp_(float(lo), float(hi))
    return y.to(out_dtype)


def _resize_route(in_dtype: torch.dtype, out_dtype: torch.dtype, method: str,
                  antialias: bool, align_corners: bool, scale_factors, backend: str,
                  pil_args: bool = False) -> str:
    """The route :func:`resize` takes for these arguments (``backend``
    resolved; ``pil_args``: a box or a reducing_gap was given), which
    ``utils.inspect.kernel_report`` reads too:

      * ``'nearest_legacy'`` — an index gather, no kernel;
      * ``'pil_exact'`` — ``backend='pil_exact'``;
      * ``'pil_box'`` — uint8 -> uint8 ``auto`` with a box or reducing_gap:
        PIL semantics are the contract, so the call stays byte-exact
        through the Pillow route on every device;
      * ``'pil_auto'`` — uint8 -> uint8 ``auto`` with plain PIL semantics,
        promoted to the byte-exact Pillow kernel;
      * ``'u8_kernel'`` — the other uint8 calls under ``auto``/``pallas``
        with a kernel output dtype: resample2d decodes and encodes inside
        the kernel, so the image crosses device memory at 1 byte/px on
        input (and output for u8 -> u8, whose intermediate is quantised to
        the u8 lattice like Pillow's);
      * ``'plane'`` — :func:`resize_plane` in the compute dtype.
    """
    u8_to_u8 = in_dtype == torch.uint8 and out_dtype == torch.uint8
    if method == "nearest_legacy":
        return "nearest_legacy"
    if backend == "pil_exact":
        return "pil_exact"
    if pil_args and u8_to_u8 and backend == "auto" and antialias:
        return "pil_box"
    if (u8_to_u8 and backend == "auto" and antialias and not align_corners
            and scale_factors is None and method in _PIL_AUTO_METHODS):
        return "pil_auto"
    if in_dtype == torch.uint8 and out_dtype in KERNEL_DTYPES and backend in ("auto", "pallas"):
        return "u8_kernel"
    return "plane"


@spanned("ia.ops.resize")
def resize(
    x: torch.Tensor,
    size: Sequence[int],
    method: str = "bilinear",
    antialias: bool = True,
    align_corners: bool = False,
    data_format: str | None = None,
    backend: str | None = None,
    output_dtype=None,
    scale_factors: tuple[float, float] | None = None,
    box: tuple[float, float, float, float] | None = None,
    reducing_gap: float | None = None,
    options=None,
) -> torch.Tensor:
    """Antialiased (or classic) separable image resize — the JAX package's
    signature.

    * ``x``: 2-D ``[H, W]``, 3-D ``[C, H, W]`` / ``[H, W, C]``, or batched
      4-D+ tensor, on any device; the result lies on the same device.
      uint8, float32, float64 or bfloat16 (native), plus float16 and other
      integer images, which compute in float32 (up to 16 bits) or float64
      (wider) and cast back; integers round ``floor(v + 0.5)`` clamped to
      the dtype range.
    * ``size``: output ``(height, width)``.
    * ``method``: bilinear | bicubic | nearest (≡ PIL box when antialias) |
      box | lanczos3 | lanczos5 | hamming | area (torch's adaptive-average-
      pool window rule) | nearest_legacy (torch's asymmetric
      ``mode='nearest'`` rounding, byte-exact, always non-AA).
    * uint8 -> uint8 with ``backend='auto'`` (the default), antialias and
      Pillow semantics runs Pillow's integer pipeline, byte-identical to
      ``PIL.Image.resize`` (the JAX package returns the same bytes on its
      accelerator).  ``backend='pil_exact'`` asks for that route
      explicitly.  Other uint8 calls resample in float32 and round back
      PIL-style.
    * ``box``: optional fractional source window ``(x0, y0, x1, y1)`` in PIL
      order (x = width axis); uint8 is byte-identical to
      ``PIL.Image.resize(size, resample, box=box)``, float is the continuous
      analogue.
    * ``reducing_gap``: PIL's two-step shortcut (integer
      :func:`..ops.pil_exact.reduce_pil_exact` first, then the resample),
      byte-identical to ``PIL.Image.resize(..., reducing_gap=g)``.  uint8
      -> uint8 Pillow routes only (``auto`` or ``pil_exact``, antialias, no
      align_corners / scale_factors); other routes raise ValueError.
    """
    if options is not None:
        explicit = (
            method != "bilinear"
            or antialias is not True
            or align_corners is not False
            or backend is not None
            or output_dtype is not None
            or scale_factors is not None
        )
        if explicit:
            raise ValueError(
                "pass either options=ResizeOptions(...) or the individual "
                "keyword arguments, not both"
            )
        method = options.method
        antialias = options.antialias
        align_corners = options.align_corners
        backend = options.backend
        data_format = options.data_format if options.data_format else data_format
        output_dtype = options.output_dtype
    oh, ow = int(size[0]), int(size[1])
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"output size must be positive, got ({oh}, {ow})"
        )
    h_axis, w_axis = _axes_for(x, data_format)
    if x.shape[h_axis] <= 0 or x.shape[w_axis] <= 0:
        raise ValueError(
            "input spatial size must be positive, got "
            f"{x.shape[h_axis]}x{x.shape[w_axis]} (resampling from an "
            "empty plane is undefined; the reference raises the same way)"
        )
    span_h = span_w = None
    if box is not None:
        if method in ("area", "nearest_legacy"):
            raise ValueError(f"box is not defined for method={method!r}")
        if align_corners or scale_factors is not None:
            raise ValueError(
                "box follows PIL.Image.resize semantics: no "
                "align_corners/scale_factors"
            )
        bx0, by0, bx1, by1 = (float(v) for v in box)
        iw, ih = x.shape[w_axis], x.shape[h_axis]
        if not (0.0 <= bx0 < bx1 <= iw and 0.0 <= by0 < by1 <= ih):
            raise ValueError(
                f"box {box} must lie within (0, 0, {iw}, {ih}) with "
                "x0 < x1 and y0 < y1 (PIL order: x = width axis)"
            )
        span_w, span_h = (bx0, bx1), (by0, by1)
    in_dtype = x.dtype
    out_dtype = output_dtype if output_dtype is not None else in_dtype
    u8_to_u8 = in_dtype == torch.uint8 and out_dtype == torch.uint8
    backend_resolved = backend or default_backend()
    route = _resize_route(in_dtype, out_dtype, method, antialias, align_corners,
                          scale_factors, backend_resolved,
                          box is not None or reducing_gap is not None)
    if reducing_gap is not None:
        pil_route = (
            backend_resolved in ("auto", "pil_exact")
            and u8_to_u8
            and antialias
            and not align_corners
            and scale_factors is None
            and method not in ("area", "nearest_legacy")
        )
        if not pil_route:
            raise ValueError(
                "reducing_gap replicates PIL.Image.resize's uint8 two-step "
                "pipeline byte-for-byte: uint8 -> uint8 with "
                "backend='auto'/'pil_exact', antialias, no align_corners/"
                "scale_factors (reduce first yourself for other routes)"
            )
    if route == "nearest_legacy":
        # Pure index gather, byte-exact vs torch mode='nearest' (always
        # non-AA; the method name implies it, so antialias is ignored).
        if align_corners:
            raise ValueError("nearest_legacy does not take align_corners")
        y = _resize_nearest_legacy(x, oh, ow, h_axis, w_axis, scale_factors)
        return y.to(out_dtype)
    if backend_resolved not in _BACKENDS:
        raise ValueError(
            f"unknown backend {backend_resolved!r}; expected one of {_BACKENDS}")
    if route == "pil_exact":
        if not u8_to_u8:
            raise ValueError("backend='pil_exact' is the uint8 (8bpc) pipeline")
        if not antialias or align_corners or scale_factors is not None:
            raise ValueError(
                "backend='pil_exact' emulates PIL.Image.resize: antialias "
                "only, no align_corners/scale_factors"
            )
        return resize_pil_exact(
            x, (oh, ow), method=method, data_format=data_format, box=box,
            reducing_gap=reducing_gap,
        )
    pil_method = "box" if method == "nearest" else method
    if route == "pil_box":
        if debug_enabled():
            print("[ia-tpu] uint8 auto + box/reducing_gap -> pil_exact")
        return resize_pil_exact(
            x, (oh, ow), method=pil_method, data_format=data_format, box=box,
            reducing_gap=reducing_gap,
        )
    # Every layout _axes_for yields is trailing-HW or channels-last, both of
    # which the Pillow route takes.
    if route == "pil_auto":
        if debug_enabled():
            print("[ia-tpu] uint8 auto -> pil_exact")
        return resize_pil_exact(
            x, (oh, ow), method=pil_method, data_format=data_format
        )
    # Every layout _axes_for yields is trailing-HW or channels-last;
    # channels-last moves through NCHW around the kernel.
    if route == "u8_kernel":
        sfh, sfw = scale_factors if scale_factors is not None else (None, None)
        spec_w = make_axis_spec(
            x.shape[w_axis], ow, method, antialias, align_corners, sfw,
            span=span_w,
        )
        spec_h = make_axis_spec(
            x.shape[h_axis], oh, method, antialias, align_corners, sfh,
            span=span_h,
        )
        if h_axis == x.ndim - 3:  # channels-last
            y = resize2d(x.movedim(-1, -3), spec_h, spec_w, out_dtype=out_dtype)
            return y.movedim(-3, -1)
        return resize2d(x, spec_h, spec_w, out_dtype=out_dtype)
    cdtype = _compute_dtype(in_dtype)
    y = resize_plane(
        x.to(cdtype),
        (oh, ow),
        h_axis,
        w_axis,
        mode=method,
        antialias=antialias,
        align_corners=align_corners,
        backend=backend,
        scale_factors=scale_factors,
        span_h=span_h,
        span_w=span_w,
    )
    return _finalize_dtype(y, out_dtype)


def interpolate(
    x: torch.Tensor,
    size: Sequence[int] | None = None,
    scale_factor: float | Sequence[float] | None = None,
    mode: str = "bilinear",
    align_corners: bool = False,
    antialias: bool = True,
    data_format: str | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """torch.nn.functional.interpolate-shaped shim over :func:`resize`.

    torch mode aliases are honoured: ``area`` is torch's adaptive-average-
    pool window rule; ``nearest`` maps to torch's legacy asymmetric rounding
    (``floor(i*scale)``, byte-exact); ``nearest-exact`` to the corrected
    rounding.  The nearest modes disable antialias.  ``linear`` (3-D
    ``[N, C, W]``) and ``trilinear`` (5-D ``[N, C, D, H, W]``) run the
    separable pass over 1 / 3 trailing axes (with ``antialias=True`` they
    are the AA generalisation torch rejects).
    """
    nearest_family = mode in ("nearest", "nearest_legacy", "nearest-exact")
    if mode in ("linear", "trilinear") or (
        (nearest_family or mode == "area") and x.ndim in (3, 5)
    ):
        n_sp = 1 if mode == "linear" else 3 if mode == "trilinear" else x.ndim - 2
        if x.ndim != 2 + n_sp:
            raise ValueError(
                f"mode='{mode}' expects a {2 + n_sp}-D [N, C, "
                f"{'W' if n_sp == 1 else 'D, H, W'}] tensor, got {x.ndim}-D"
            )
        if data_format not in (None, "channels_first"):
            raise ValueError(f"mode='{mode}' supports channels_first only")
        axes = tuple(range(x.ndim - n_sp, x.ndim))
        sfs = [None] * n_sp
        if size is None:
            if scale_factor is None:
                raise ValueError("one of size / scale_factor is required")
            if isinstance(scale_factor, (int, float)):
                scale_factor = (float(scale_factor),) * n_sp
            if len(scale_factor) != n_sp:
                raise ValueError(
                    f"scale_factor must be a scalar or length-{n_sp}"
                )
            sfs = [float(s) for s in scale_factor]
            sizes = [int(x.shape[a] * s) for a, s in zip(axes, sfs)]
        else:
            sizes = (
                [int(size)] * n_sp
                if isinstance(size, (int, np.integer))
                else [int(s) for s in size]
            )
            if len(sizes) != n_sp:
                raise ValueError(f"size must be a scalar or length-{n_sp}")
        if mode in ("nearest", "nearest_legacy"):
            # legacy asymmetric rounding, byte-exact per axis (pure gathers;
            # keeps ATen's f32-size/f64-scale_factor index quirk)
            y = x
            for a, sz, s in zip(axes, sizes, sfs):
                y = _take(y, _legacy_nearest_indices(x.shape[a], sz, s), a)
            return y
        if mode == "nearest-exact":
            return resize_nd(
                x, sizes, axes, method="nearest", antialias=False,
                backend=backend,
            )
        if mode == "area":
            # adaptive_avg_pool windows factorise exactly across axes
            return resize_nd(
                x, sizes, axes, method="area", antialias=True,
                backend=backend,
            )
        return resize_nd(
            x, sizes, axes, method="bilinear", antialias=antialias,
            align_corners=align_corners, backend=backend,
        )
    if mode == "area":
        antialias = True
    elif mode in ("nearest", "nearest_legacy"):
        mode, antialias = "nearest_legacy", False
    elif mode == "nearest-exact":
        mode, antialias = "nearest", False
    h_axis, w_axis = _axes_for(x, data_format)
    sf = None
    if size is None:
        if scale_factor is None:
            raise ValueError("one of size / scale_factor is required")
        if isinstance(scale_factor, (int, float)):
            scale_factor = (float(scale_factor), float(scale_factor))
        sf = (float(scale_factor[0]), float(scale_factor[1]))
        size = (
            int(x.shape[h_axis] * sf[0]),
            int(x.shape[w_axis] * sf[1]),
        )
    return resize(
        x,
        size,
        method=mode,
        antialias=antialias,
        align_corners=align_corners,
        data_format=data_format,
        backend=backend,
        scale_factors=sf,
    )


def image_resize(
    image: torch.Tensor,
    shape: Sequence[int],
    method: str = "bilinear",
    antialias: bool = True,
) -> torch.Tensor:
    """Drop-in for ``jax.image.resize(image, shape, method, antialias)``.

    Resizes every axis whose target differs from the source (separable
    passes, Pillow-parity weights).  Accepts the jax.image method vocabulary
    (``linear`` / ``bilinear`` / ``trilinear`` / ``cubic`` / ``lanczos3`` /
    ``lanczos5``); ``nearest`` here means PIL's box filter under antialias.
    """
    if len(shape) != image.ndim:
        raise ValueError(f"shape must have rank {image.ndim}, got {len(shape)}")
    axes = [i for i in range(image.ndim) if int(shape[i]) != image.shape[i]]
    if not axes:
        return image
    if image.ndim >= 2 and axes == [image.ndim - 2, image.ndim - 1]:
        # both trailing axes change: the full resize() dispatcher (two-pass
        # kernel, Pillow route for eligible uint8); a single changed axis
        # stays on resize_nd's per-axis pass
        return resize(
            image,
            (int(shape[image.ndim - 2]), int(shape[image.ndim - 1])),
            method=method,
            antialias=antialias,
        )
    return resize_nd(
        image, [int(shape[i]) for i in axes], axes, method=method,
        antialias=antialias,
    )


def resize_nd(
    x: torch.Tensor,
    sizes: Sequence[int],
    axes: Sequence[int],
    method: str = "bilinear",
    antialias: bool = True,
    align_corners: bool = False,
    backend: str | None = None,
) -> torch.Tensor:
    """Separable N-D resize: one pass per axis, innermost first (e.g. an
    antialiased trilinear volume resize with ``axes=(-3, -2, -1)``).  Under
    ``auto``/``pallas`` each pass runs the resample_axis kernel.
    Differentiable (each pass is a linear op with its exact adjoint)."""
    if len(sizes) != len(axes):
        raise ValueError("sizes and axes must have equal length")
    backend = backend or default_backend()
    y = x.to(_compute_dtype(x.dtype))
    order = sorted(zip(axes, sizes), key=lambda t: -(t[0] % x.ndim))
    for ax, sz in order:  # innermost axis first, like the separable driver
        spec = make_axis_spec(y.shape[ax], int(sz), method, antialias, align_corners)
        y = _apply_axis_diff(y, spec, ax % y.ndim, backend)
    return _finalize_dtype(y, x.dtype)
