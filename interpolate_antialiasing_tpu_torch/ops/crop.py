"""Antialiased crop-and-resize with per-image boxes (the port of
``interpolate_antialiasing_tpu.ops.crop``).

Three routes:

  * **windowed** (:mod:`.crop_cuda`, the ``crop_resample`` kernel): uint8,
    non-negative filters, no flip — the default for those calls on every
    device, as on the JAX package's accelerator;
  * **float32 windowed** (:func:`.crop_cuda.crop_and_resize_f32`): uint8,
    antialiased, a filter the table kernel evaluates, **with** a flip, on a
    CUDA tensor — the dense route's arithmetic (float32 weights, products
    and intermediate, one rounding, no window truncation) over each row's
    nonzero taps, the flip folded into the W tables;
  * **dense**: per-image weight matrices ``W_h[n] [OH, H]`` and ``W_w[n]
    [OW, W]`` (the PIL algorithm on the box interval, masked and
    renormalised per row: :func:`_axis_matrix`) applied as two batched
    float32 matrix products at full precision (TF32 off), then the
    library's storage-dtype rule.  Differentiable with respect to the image
    **and the boxes** through plain torch ops.  Every other call takes it:
    float input, negative-lobe filters, ``use_windowed=False``, and every
    flipped call on the CPU, which stays byte-equal to the JAX package's
    dense route.  This is what the JAX package computes off the TPU; its
    TPU-only variants of this route (split-bf16 weights and int8 digit
    contractions, ``split`` / ``one_digits``) exist for the TPU's
    matrix-unit rate, are not Pallas kernels, and are not ported.
"""

from __future__ import annotations

import math
import warnings
from functools import cache

import torch

from ..config import full_f32
from ..utils.trace import span, spanned
from .filters import CUBIC_NAMES, get_filter

__all__ = ["crop_and_resize", "random_resized_crop", "sample_boxes",
           "box_fracs"]


@cache
def _warn_classic_border_divergence() -> None:
    """One-time notice that ``antialias=False`` renormalises at the crop
    borders where torch's classic kernels replicate."""
    warnings.warn(
        "crop_and_resize(antialias=False): borders renormalise over the "
        "traced window (PIL convention) instead of torch's replicate fold "
        "— outputs can differ from crop-then-torch-interpolate in the "
        "outermost rows/cols. Use antialias=True (exact) or resize() on a "
        "pre-cropped image for torch-classic border semantics.",
        stacklevel=3,
    )


def _axis_matrix(lo: torch.Tensor, hi: torch.Tensor, in_size: int,
                 out_size: int, mode: str, antialias: bool,
                 flip: torch.Tensor | None = None) -> torch.Tensor:
    """Dense ``[N, out_size, in_size]`` resampling matrices for the crop
    intervals ``[lo, hi)`` (``[N]`` float32, pixel units):

      center_o = lo + scale * (o + 0.5),  scale = (hi - lo) / out_size
      support  = filt.support * max(scale, 1)   (antialias)
      w[o, i]  = filter((i - center_o + 0.5) / max(scale, 1))

    over the taps whose centres lie in the box and within the support, rows
    renormalised (PIL border renormalisation).  ``flip`` (``[N]`` bool)
    mirrors the sampling grid: output ``o`` reads the window of
    ``out - 1 - o``.  A sub-pixel box that traps no pixel centre samples the
    nearest pixel (``torch.round`` rounds half to even, as ``jnp.round``
    does)."""
    # the library's non-AA convention: classic bicubic is Keys a=-0.75;
    # borders still renormalise (documented divergence, warned once)
    if not antialias and get_filter(mode).name in CUBIC_NAMES:
        mode = "bicubic075"
    filt = get_filter(mode)
    dev = lo.device
    lo = lo[:, None, None]
    hi = hi[:, None, None]
    scale = (hi - lo) / out_size  # source pixels per output pixel
    one = torch.ones((), dtype=torch.float32, device=dev)
    widen = torch.maximum(scale, one) if antialias else one
    support = filt.support * widen

    o = torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
    if flip is not None:
        o = torch.where(flip[:, None, None], float(out_size - 1) - o, o)
    i = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :]
    center = lo + scale * (o + 0.5)
    w = filt((i - center + 0.5) / widen, torch)
    valid = (
        (torch.abs(i - center + 0.5) <= support)
        & (i + 0.5 >= lo)
        & (i + 0.5 <= hi)
    )
    w = torch.where(valid, w, 0.0)
    total = w.sum(dim=-1, keepdim=True)
    nearest = torch.clamp(torch.round(center - 0.5), 0.0, float(in_size - 1))
    onehot = (i == nearest).to(w.dtype)
    return torch.where(total > 0.0, w / torch.where(total == 0.0, 1.0, total),
                       onehot)


@spanned("ia.ops.crop_and_resize")
def crop_and_resize(
    x: torch.Tensor,
    boxes: torch.Tensor,
    out_hw: tuple[int, int],
    method: str = "bilinear",
    antialias: bool = True,
    max_box_frac=1.0,
    use_windowed: bool | None = None,
    flip: torch.Tensor | None = None,
) -> torch.Tensor:
    """Antialiased crop+resize (the AA analogue of
    ``tf.image.crop_and_resize``).

    * ``x``: ``[N, C, H, W]``, uint8 or float (uint8 rounds back
      ``floor(v + 0.5)`` clamped; float keeps its dtype).
    * ``boxes``: ``[N, 4]`` float, per-image ``(y0, x0, y1, x1)`` in
      normalised [0, 1] corner coordinates.
    * returns ``[N, C, OH, OW]``.
    * ``max_box_frac``: bound on the box span per axis as a fraction of the
      image (scalar or ``(frac_h, frac_w)``); the windowed route sizes its
      windows from it, and a box larger than the bound renormalises over
      the truncated window there.  The other routes never truncate.
    * ``use_windowed``: None routes uint8, non-negative-filter calls
      without ``flip`` to the windowed kernel (:mod:`.crop_cuda`), uint8
      antialiased calls with ``flip`` on a CUDA tensor whose filter the
      table kernel evaluates to the float32 windowed route, and the rest to
      the dense route; True does the same, and False forces the dense
      route.
    * ``flip``: optional ``[N]`` bool, a per-image horizontal mirror folded
      into the W weights (the float32 windowed route's tables, or the
      dense route's matrices).

    The dense route is differentiable with respect to ``x`` and ``boxes``.
    """
    if x.ndim != 4:
        raise ValueError("crop_and_resize expects NCHW input")
    if boxes.ndim != 2 or boxes.shape[-1] != 4:
        raise ValueError("boxes must be [N, 4] (y0, x0, y1, x1)")
    if not antialias:
        _warn_classic_border_divergence()
    if flip is not None and tuple(flip.shape) != (x.shape[0],):
        raise ValueError(f"flip must be [N] bools, got {tuple(flip.shape)}")
    if use_windowed is not False:
        from . import crop_cuda as cc

        if flip is None:
            if cc.crop_windowed_supported(x, out_hw, method, antialias, max_box_frac):
                return cc.crop_and_resize_windowed(
                    x, boxes.float(), out_hw, method=method, antialias=antialias,
                    max_box_frac=max_box_frac,
                )
        elif x.device.type == "cuda" and cc.crop_f32_supported(x, method, antialias):
            return cc.crop_and_resize_f32(x, boxes.float(), out_hw, method=method, flip=flip)
    from .resize import _finalize_dtype

    N, C, H, W = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    b = boxes.to(device=x.device, dtype=torch.float32)
    fl = None if flip is None else flip.to(device=x.device, dtype=torch.bool)
    with span("ia.tables.crop_dense"):
        Wh = _axis_matrix(b[:, 0] * H, b[:, 2] * H, H, oh, method, antialias)
    with span("ia.tables.crop_dense"):
        Ww = _axis_matrix(b[:, 1] * W, b[:, 3] * W, W, ow, method, antialias, flip=fl)
    with full_f32():
        t = torch.matmul(Wh[:, None], x.float())  # [N, C, oh, W]
        y = torch.matmul(t, Ww.transpose(1, 2)[:, None])  # [N, C, oh, ow]
    return _finalize_dtype(y, x.dtype)


def box_fracs(H: int, W: int, scale=(0.08, 1.0),
              ratio=(3.0 / 4.0, 4.0 / 3.0)) -> tuple[float, float]:
    """The per-axis span bound of :func:`sample_boxes`' boxes, from its own
    ``scale``/``ratio``: ``ch <= sqrt(scale_max H W / ratio_min)``, ``cw <=
    sqrt(scale_max H W ratio_max)``."""
    frac_h = min(1.0, math.sqrt(scale[1] * (W / H) / ratio[0]))
    frac_w = min(1.0, math.sqrt(scale[1] * (H / W) * ratio[1]))
    return frac_h, frac_w


def sample_boxes(generator: torch.Generator | None, N: int, H: int, W: int,
                 scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 device=None) -> torch.Tensor:
    """RandomResizedCrop boxes ``[N, 4]`` (normalised ``(y0, x0, y1, x1)``):
    area fraction uniform in ``scale``, aspect ratio log-uniform in
    ``ratio``, the box clamped to fit and placed uniformly — single-shot
    sampling with clamping, as the JAX package does (torchvision's
    10-attempt rejection loop needs data-dependent control flow).  Random
    numbers come from ``generator`` on its own device; the boxes are moved
    to ``device``."""
    gdev = generator.device if generator is not None else torch.device("cpu")

    def u(lo=0.0, hi=1.0):
        return torch.rand(N, generator=generator, device=gdev) * (hi - lo) + lo

    area = u(scale[0], scale[1]) * (H * W)
    r = torch.exp(u(math.log(ratio[0]), math.log(ratio[1])))  # aspect = w/h
    cw = torch.clamp(torch.sqrt(area * r), max=float(W))
    ch = torch.clamp(torch.sqrt(area / r), max=float(H))
    oy = u() * (H - ch)
    ox = u() * (W - cw)
    boxes = torch.stack([oy / H, ox / W, (oy + ch) / H, (ox + cw) / W], dim=-1)
    return boxes.to(device if device is not None else gdev)


def random_resized_crop(
    generator: torch.Generator | None,
    x: torch.Tensor,
    out_hw: tuple[int, int],
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    method: str = "bilinear",
    antialias: bool = True,
    flip: torch.Tensor | None = None,
) -> torch.Tensor:
    """Antialiased RandomResizedCrop (ImageNet train augmentation): boxes
    from :func:`sample_boxes`, then :func:`crop_and_resize` with the span
    bound the sampler guarantees (:func:`box_fracs`).  ``torch.Generator``
    takes the place of the JAX package's PRNG key (the numbers differ)."""
    if x.ndim != 4:
        raise ValueError("random_resized_crop expects NCHW input")
    N, C, H, W = x.shape
    boxes = sample_boxes(generator, N, H, W, scale, ratio, device=x.device)
    return crop_and_resize(
        x, boxes, out_hw, method=method, antialias=antialias,
        max_box_frac=box_fracs(H, W, scale, ratio), flip=flip,
    )
