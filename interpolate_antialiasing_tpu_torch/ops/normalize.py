"""The pipelines' normalisation: ``((y * float32(1/255)) - mean) / std``,
then the output dtype, as the JAX package's pipelines compute it.

:func:`normalize` is the route.  On a CUDA tensor it always runs
``csrc/normalize.cu``, once (:func:`_normalize_cuda`, counted
``native.launches["normalize"]``): the input read once through its
strides, the output written once.  The kernel reads uint8 or float32 with
a unit-stride last axis and writes float32 or bfloat16; any other input is
first cast to float32 or made contiguous, and any other output is written
as float32 and cast, which are the plain expression's own casts.  A mean
or std that is not one float32 value per channel, or a call that autograd
records, raises.  On the CPU the plain expression runs
(:func:`_normalize_plain`).  The kernel rounds each step once in the plain
expression's order, so the two agree bit for bit on the card.
"""

from __future__ import annotations

import torch

from .. import native

__all__ = ["normalize"]

# float32(1/255): the plain expression multiplies by this float32 tensor;
# the kernel gets the same value as a C float
_RECIP_255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)
_SCALE = float(_RECIP_255)
_IN = (torch.uint8, torch.float32)
_OUT = (torch.float32, torch.bfloat16)
# the kernel's rows per block: one warp per row (csrc/normalize.cu: kWarps)
_ROWS_PER_BLOCK = 8


def _normalize_plain(y: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """The expression, op for op: cast, multiply by the float32 reciprocal
    of 255 (as the JAX pipeline does), subtract, divide, cast."""
    y = y.to(torch.float32) * _RECIP_255
    return ((y - mean.to(y.device)) / std.to(y.device)).to(dtype)


def _per_channel(t: torch.Tensor, C: int) -> bool:
    """``t`` holds C float32 values, one per channel: ``[1, C, 1, 1]`` or
    ``[C, 1, 1]``."""
    return (t.dtype is torch.float32 and t.numel() == C and t.dim() in (3, 4)
            and t.shape[-3] == C)


def _normalize_cuda(y: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """One launch of ``csrc/normalize.cu`` into a new contiguous output
    (none for an empty one), after the casts the module docstring names."""
    if y.dim() != 4:
        raise ValueError(f"normalize takes [N, C, H, W], not {tuple(y.shape)}")
    N, C, H, W = y.shape
    if not (_per_channel(mean, C) and _per_channel(std, C)):
        raise ValueError(f"normalize takes one float32 mean and std per channel, not "
                         f"{tuple(mean.shape)} {mean.dtype} and {tuple(std.shape)} {std.dtype}")
    if torch.is_grad_enabled() and (y.requires_grad or mean.requires_grad or std.requires_grad):
        raise ValueError("normalize has no backward on the card")
    if N * C * H >= 2**31:
        raise ValueError(f"normalize takes fewer than 2^31 rows, not {N * C * H}")
    if y.dtype not in _IN:
        y = y.to(torch.float32)
    if y.stride(3) != 1:
        y = y.contiguous()
    mean, std = mean.to(y.device).contiguous(), std.to(y.device).contiguous()
    odt = dtype if dtype in _OUT else torch.float32
    out = torch.empty(y.shape, dtype=odt, device=y.device)
    if out.numel():
        blocks = -(-N * C * H // _ROWS_PER_BLOCK)
        sn, sc, sh, _ = y.stride()
        native.launch("normalize", y.device, y.data_ptr(), out.data_ptr(),
                      native.DTYPES[y.dtype], native.DTYPES[odt], N, C, H, W, sn, sc, sh,
                      mean.data_ptr(), std.data_ptr(), _SCALE, blocks)
    return out if odt is dtype else out.to(dtype)


def normalize(y: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``((y * float32(1/255)) - mean) / std`` in float32, then ``dtype``:
    the kernel on a CUDA tensor, the plain expression on the CPU (module
    docstring)."""
    if y.is_cuda:
        return _normalize_cuda(y, mean, std, dtype)
    return _normalize_plain(y, mean, std, dtype)
