"""Antialiased crop-and-resize with per-image boxes, in plain torch, from
the definition: the PIL resample on the box interval (each output's taps
are the input pixels whose centres lie inside the box and inside the
filter's support, widened by the box's scale, and each row's weights are
divided by their sum).

Two semantics, one for each route of ``crop_and_resize`` on uint8:

* :func:`crop_dense`: the crop in real arithmetic (float64 here), rounded
  once to the uint8 lattice with ``floor(v + 0.5)``; a flip mirrors the
  output along W.  ``tf32=True`` rounds both operands of each product to
  TF32 and sums in float32 (what a float32 matrix product with TF32 on
  computes): the control one precision below float32.
* :func:`crop_windowed`: fixed-point weights ``round_half_away(w *
  2**bits)``, an H pass, then a W pass, each rounded onto the uint8
  lattice with ``(sum + 2**(bits - 1)) >> bits``, at the ``bits`` the
  configuration states for the route.

A pixel centre that lies on a box edge to within the edge's float32
resolution (:func:`edge_resolution`) is in the box or out of it, as the
rounding of the edge falls: ``side`` -1 takes such centres in, +1 leaves
them out, 0 decides exactly.  :func:`on_edge` says whether a batch has one.
"""

from __future__ import annotations

import torch

_SUPPORT = {"bilinear": 1.0}


def _tri(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    return torch.where(x < 1.0, 1.0 - x, torch.zeros_like(x))


def edge_resolution(size: int) -> float:
    """One float32 unit in the last place at ``size`` pixels: how finely a
    box edge given in float32 falls on an axis of ``size`` pixels."""
    return size * 2.0 ** -23


def on_edge(boxes: torch.Tensor, H: int, W: int) -> bool:
    """Whether a pixel centre lies on an edge of one of ``boxes`` to within
    the edge's resolution."""
    b = boxes.to(torch.float64)
    for cols, n in (((0, 2), H), ((1, 3), W)):
        v = b[:, cols] * n - 0.5
        if bool(((v - torch.round(v)).abs() <= edge_resolution(n)).any()):
            return True
    return False


def band(lo: torch.Tensor, hi: torch.Tensor, in_size: int, out_size: int,
         method: str = "bilinear", side: int = 0) -> torch.Tensor:
    """``[N, out_size, in_size]`` float64 weights of the boxes ``[lo, hi)``
    (``[N]``, pixel units), each row summing to 1 (a box that holds no
    pixel centre samples the nearest pixel); ``side`` as the module
    says."""
    support0 = _SUPPORT[method]
    lo = lo.to(torch.float64)[:, None, None]
    hi = hi.to(torch.float64)[:, None, None]
    dev = lo.device
    scale = (hi - lo) / out_size
    widen = torch.clamp(scale, min=1.0)
    o = torch.arange(out_size, dtype=torch.float64, device=dev)[None, :, None]
    i = torch.arange(in_size, dtype=torch.float64, device=dev)[None, None, :]
    center = lo + scale * (o + 0.5)
    d = i - center + 0.5
    edge = side * edge_resolution(in_size)
    inside = (d.abs() <= support0 * widen) & (i + 0.5 >= lo + edge) & (i + 0.5 <= hi - edge)
    w = torch.where(inside, _tri(d / widen), torch.zeros_like(d))
    total = w.sum(-1, keepdim=True)
    nearest = torch.clamp(torch.round(center - 0.5), 0.0, in_size - 1.0)
    onehot = (i == nearest).to(torch.float64)
    return torch.where(total > 0, w / torch.where(total > 0, total, 1.0), onehot)


def _bands(boxes: torch.Tensor, H: int, W: int, oh: int, ow: int, method: str,
           side: int = 0):
    b = boxes.to(torch.float64)
    return (band(b[:, 0] * H, b[:, 2] * H, H, oh, method, side),
            band(b[:, 1] * W, b[:, 3] * W, W, ow, method, side))


def _to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 stored mantissa bits, to nearest even."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def crop_dense(x: torch.Tensor, boxes: torch.Tensor, oh: int, ow: int,
               flip: torch.Tensor | None = None, method: str = "bilinear",
               tf32: bool = False, side: int = 0) -> torch.Tensor:
    """Grey levels (float64 ``[N, C, oh, ow]``) of the crops of uint8
    ``x [N, C, H, W]`` at ``boxes [N, 4]`` (normalised ``y0, x0, y1,
    x1``), H first, mirrored along W where ``flip``."""
    N, C, H, W = x.shape
    wh, ww = _bands(boxes, H, W, oh, ow, method, side)
    if tf32:
        f = _to_tf32
        y = f(f(wh)[:, None] @ f(x)) @ f(ww).transpose(1, 2)[:, None]
    else:
        y = (wh[:, None] @ x.to(torch.float64)) @ ww.transpose(1, 2)[:, None]
    y = torch.clamp(torch.floor(y.to(torch.float64) + 0.5), 0.0, 255.0)
    if flip is not None:
        y = torch.where(flip.to(torch.bool)[:, None, None, None], y.flip(-1), y)
    return y


def _fixed(w: torch.Tensor, bits: int) -> torch.Tensor:
    s = w * float(1 << bits)
    return torch.where(s < 0, torch.trunc(s - 0.5), torch.trunc(s + 0.5))


def _lattice(acc: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.clamp(torch.floor((acc + float(1 << (bits - 1))) / float(1 << bits)),
                       0.0, 255.0)


def crop_windowed(x: torch.Tensor, boxes: torch.Tensor, oh: int, ow: int,
                  bits_h: int, bits_w: int, method: str = "bilinear",
                  side: int = 0) -> torch.Tensor:
    """Grey levels (float64 ``[N, C, oh, ow]``) of the two-pass fixed-point
    crop: the H pass onto the uint8 lattice, then the W pass.  Integer
    matrices in float64: every sum is exact."""
    N, C, H, W = x.shape
    wh, ww = _bands(boxes, H, W, oh, ow, method, side)
    inter = _lattice(_fixed(wh, bits_h)[:, None] @ x.to(torch.float64), bits_h)
    return _lattice(inter @ _fixed(ww, bits_w).transpose(1, 2)[:, None], bits_w)


def box_bytes(boxes: torch.Tensor, H: int, W: int, channels: int) -> int:
    """Input bytes a uint8 crop needs: the pixels whose centres lie in each
    box, ``channels`` bytes each."""
    b = boxes.to(torch.float64)

    def count(lo, hi, n):
        first = torch.clamp(torch.ceil(lo - 0.5), min=0.0)
        last = torch.clamp(torch.floor(hi - 0.5), max=n - 1.0)
        return torch.clamp(last - first + 1.0, min=0.0)

    rows = count(b[:, 0] * H, b[:, 2] * H, H)
    cols = count(b[:, 1] * W, b[:, 3] * W, W)
    return int((rows * cols).sum().item()) * channels

