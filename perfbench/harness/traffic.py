"""The one generator of the benchmark's inputs, driven by a traffic mix's
parameters and the seed.  Everything is drawn on the device from one
``torch.Generator`` in a fixed order, so the same seed gives the same
inputs.
"""

from __future__ import annotations

import math
import random

import torch


def generator(seed: int, device) -> torch.Generator:
    """The run's generator on ``device``, seeded with ``seed`` (any whole
    number; taken modulo 2**64)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def images(gen: torch.Generator, pool: int, batch: int, shape, device) -> torch.Tensor:
    """``[pool, batch, *shape]`` uniform uint8 images, in one call."""
    return torch.randint(0, 256, (pool, batch, *shape), dtype=torch.uint8,
                         generator=gen, device=device)


def resized_crop_boxes(gen: torch.Generator, n: int, H: int, W: int, scale, ratio,
                       device) -> torch.Tensor:
    """``[n, 4]`` normalised ``(y0, x0, y1, x1)`` boxes by torchvision's
    RandomResizedCrop rule, drawn once each (no retry loop): the area a
    uniform share of the image in ``scale``, the aspect ratio (w / h)
    log-uniform in ``ratio``, each side clamped to the image, the box
    placed uniformly."""
    def u(lo=0.0, hi=1.0):
        return torch.rand(n, generator=gen, device=device, dtype=torch.float32) * (hi - lo) + lo

    area = u(scale[0], scale[1]) * (H * W)
    r = torch.exp(u(math.log(ratio[0]), math.log(ratio[1])))
    cw = torch.clamp(torch.sqrt(area * r), max=float(W))
    ch = torch.clamp(torch.sqrt(area / r), max=float(H))
    oy = u() * (H - ch)
    ox = u() * (W - cw)
    return torch.stack([oy / H, ox / W, (oy + ch) / H, (ox + cw) / W], dim=-1)


def flips(gen: torch.Generator, n: int, prob: float, device) -> torch.Tensor | None:
    """``[n]`` horizontal flips with probability ``prob``; None where
    ``prob`` is 0 (the call then passes no flip at all)."""
    if prob == 0:
        return None
    return torch.rand(n, generator=gen, device=device) < prob


class Reservoir:
    """A uniform sample of ``size`` of the calls offered, drawn from the
    seed (reservoir sampling): the calls whose outputs are compared."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.kept: list[tuple[int, object]] = []
        self._seen = 0
        self._rng = random.Random(int(seed))

    def offer(self, i: int, out) -> None:
        self._seen += 1
        if len(self.kept) < self.size:
            self.kept.append((i, out))
            return
        j = self._rng.randrange(self._seen)
        if j < self.size:
            self.kept[j] = (i, out)
