"""Public ``resize`` entry point (the port of
``interpolate_antialiasing_tpu.ops.resize.resize``).

Ported so far: the argument checks and layouts of the JAX package, and its
uint8 -> uint8 Pillow routes — ``backend='pil_exact'``, the resize ``box``,
and the ``auto`` promotion of plain antialiased uint8 resizes to
:func:`..ops.pil_exact.resize_pil_exact`.  The JAX package promotes only on
its accelerator (``_on_tpu()``, behind a VMEM admission check); the port
promotes on every device, which gives what the JAX package returns on its
accelerator: Pillow's bytes.  Every other route (float inputs, non-antialiased
and ``align_corners`` resizes, ``area``, ``nearest_legacy``, non-uint8
outputs) raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config import debug_enabled, default_backend
from .pil_exact import _PIL_AUTO_METHODS, resize_pil_exact

__all__ = ["resize"]

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

_FLOAT_ROUTE = "ROADMAP queue 1 item 3"


def _axes_for(x: torch.Tensor, data_format: str | None) -> tuple[int, int]:
    if data_format is None:
        data_format = "HW" if x.ndim == 2 else "NCHW"
    if data_format not in _FORMATS:
        raise ValueError(f"unknown data_format {data_format!r}")
    if x.ndim == 2:
        return x.ndim - 2, x.ndim - 1
    ha, wa = _FORMATS[data_format]
    return x.ndim + ha, x.ndim + wa


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
    """Antialiased separable image resize — the JAX package's signature.

    * ``x``: 2-D ``[H, W]``, 3-D ``[C, H, W]`` / ``[H, W, C]``, or batched
      4-D+ tensor, on any device; the result lies on the same device.
    * ``size``: output ``(height, width)``.
    * ``method``: bilinear | bicubic | nearest (≡ PIL box when antialias) |
      box | lanczos3 | hamming.
    * uint8 -> uint8 with ``backend='auto'`` (the default) and antialias
      runs Pillow's integer pipeline, byte-identical to ``PIL.Image.resize``
      (the JAX package returns the same bytes on its accelerator, where it
      promotes the call the same way).  ``backend='pil_exact'`` asks for that
      route explicitly.
    * ``box``: optional fractional source window ``(x0, y0, x1, y1)`` in PIL
      order (x = width axis); uint8 is byte-identical to
      ``PIL.Image.resize(size, resample, box=box)``.

    Not ported yet (NotImplementedError): float and other non-uint8 inputs
    or outputs, ``antialias=False``, ``align_corners``, ``scale_factors``,
    ``area``, ``nearest_legacy`` and ``reducing_gap``.
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
    in_dtype = x.dtype
    out_dtype = output_dtype if output_dtype is not None else in_dtype
    u8_to_u8 = in_dtype == torch.uint8 and out_dtype == torch.uint8
    backend_resolved = backend or default_backend()
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
    if method == "nearest_legacy":
        if align_corners:
            raise ValueError("nearest_legacy does not take align_corners")
        raise NotImplementedError(
            f"method='nearest_legacy' is not ported yet: {_FLOAT_ROUTE}")
    if backend_resolved not in _BACKENDS:
        raise ValueError(
            f"unknown backend {backend_resolved!r}; expected one of {_BACKENDS}")
    if backend_resolved == "pil_exact":
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
    # u8 -> u8 with a resize box: PIL semantics are the contract, so 'auto'
    # stays byte-exact through the Pillow route on every device.
    if (
        (box is not None or reducing_gap is not None)
        and u8_to_u8
        and backend_resolved == "auto"
        and antialias
    ):
        if debug_enabled():
            print("[ia-tpu] uint8 auto + box/reducing_gap -> pil_exact")
        return resize_pil_exact(
            x, (oh, ow), method=pil_method, data_format=data_format, box=box,
            reducing_gap=reducing_gap,
        )
    # u8 -> u8 with plain PIL semantics: 'auto' promotes to the byte-exact
    # Pillow kernel.  Every layout _axes_for yields is trailing-HW or
    # channels-last, both of which the route takes.
    if (
        u8_to_u8
        and backend_resolved == "auto"
        and antialias
        and not align_corners
        and scale_factors is None
        and method in _PIL_AUTO_METHODS
    ):
        if debug_enabled():
            print("[ia-tpu] uint8 auto -> pil_exact")
        return resize_pil_exact(
            x, (oh, ow), method=pil_method, data_format=data_format
        )
    raise NotImplementedError(
        f"this resize route (dtype {in_dtype} -> {out_dtype}, method="
        f"{method!r}, antialias={antialias}, align_corners={align_corners}, "
        f"scale_factors={scale_factors}, backend={backend_resolved!r}) is the "
        f"float route, which is not ported yet: {_FLOAT_ROUTE}")
