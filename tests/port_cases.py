"""Case data shared by the port's card tests (``tests/test_torch_port_cuda.py``)
and ``chip_smoke.py``, which imports this module from ``tests/``.

Only the normalisation kernel's cases live here so far; the older kernels'
cases are still taken from ``chip_smoke.py``."""

from __future__ import annotations

import math

import torch

U8, F16, F32, F64, BF16 = torch.uint8, torch.float16, torch.float32, torch.float64, torch.bfloat16

# The normalisation's cases: (name, [N, C, H, W], input dtype, output dtype,
# where the input lies in its storage: None (contiguous), (rows, cols, top,
# left) of a larger batch, an element offset into a flat storage, or
# "channels_last").  The pipelines' calls at their sizes (the train crop;
# eval's centre crop of Resize(256): 224 x 224 of rows 529 wide from column
# 152), tails, channel counts, float32 in, bfloat16 out, an empty batch,
# views whose first byte is not aligned and rows at every byte offset; and
# what the route casts before or after the kernel (float64 in, float16 and
# float64 out, a last axis that is not unit-stride).
NORMALIZE_CASES = (
    ("train crop b64", (64, 3, 224, 224), U8, F32, None),
    ("eval view b64", (64, 3, 224, 224), U8, F32, (256, 529, 16, 152)),
    ("eval view b64 bf16 out", (64, 3, 224, 224), U8, BF16, (256, 529, 16, 152)),
    ("eval view f32 in", (8, 3, 224, 224), F32, F32, (256, 529, 16, 152)),
    ("eval view f32 in bf16 out", (8, 3, 224, 224), F32, BF16, (256, 529, 16, 152)),
    ("f32 in contiguous", (4, 3, 60, 96), F32, F32, None),
    ("width 1", (4, 3, 17, 1), U8, F32, None),
    ("width 3", (4, 3, 17, 3), U8, F32, None),
    ("width 5", (4, 3, 17, 5), U8, BF16, None),
    ("width 225", (4, 3, 17, 225), U8, F32, None),
    ("width 225 f32 in", (4, 3, 17, 225), F32, BF16, None),
    ("c1", (5, 1, 33, 64), U8, F32, None),
    ("c4", (5, 4, 33, 64), U8, F32, None),
    ("c4 width 7", (5, 4, 33, 7), U8, BF16, None),
    ("empty batch", (0, 3, 224, 224), U8, F32, None),
    ("misaligned base u8", (2, 3, 40, 60), U8, F32, 3),
    ("misaligned base f32", (2, 3, 40, 60), F32, BF16, 1),
    ("every row offset", (3, 3, 48, 297), U8, F32, (50, 301, 1, 1)),
    ("f16 out", (4, 3, 17, 225), U8, F16, None),
    ("f64 out", (4, 3, 17, 64), U8, F64, None),
    ("f64 in", (4, 3, 17, 64), F64, F32, None),
    ("channels last", (4, 3, 40, 60), U8, F32, "channels_last"),
)
NORMALIZE_MEAN = (0.485, 0.456, 0.406, 0.5)
NORMALIZE_STD = (0.229, 0.224, 0.225, 0.25)


def _levels(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, device=dev, generator=g).mul_(255.0).to(dtype)


def normalize_input(case, dev, seed: int):
    """``(y, mean, std)`` of one of :data:`NORMALIZE_CASES`: the input view
    and one float32 mean and std per channel, ``[1, C, 1, 1]`` on ``dev``."""
    _, shape, idt, _, where = case
    N, C, H, W = shape
    if where is None:
        y = _levels(shape, idt, dev, seed)
    elif where == "channels_last":
        y = _levels(shape, idt, dev, seed).to(memory_format=torch.channels_last)
    elif isinstance(where, int):
        y = _levels((math.prod(shape) + where,), idt, dev, seed)[where:].reshape(shape)
    else:
        rows, cols, top, left = where
        y = _levels((N, C, rows, cols), idt, dev, seed)[..., top:top + H, left:left + W]
    mean = torch.tensor(NORMALIZE_MEAN[:C]).reshape(1, C, 1, 1).to(dev)
    std = torch.tensor(NORMALIZE_STD[:C]).reshape(1, C, 1, 1).to(dev)
    return y, mean, std
