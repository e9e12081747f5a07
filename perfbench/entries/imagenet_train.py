"""Adapter of ``ImageNetTrainPipeline.apply``: torchvision's ImageNet train
preset (RandomResizedCrop with antialias, RandomHorizontalFlip, ToTensor,
Normalize) over a pool of seeded uint8 batches, boxes and flips on the
device.

The boxes follow the RandomResizedCrop rule of the configuration's
``preset`` (:func:`perfbench.harness.traffic.resized_crop_boxes`), the
flips the traffic's ``hflip_prob``.  Where ``hflip_prob`` is 0 the call
passes no flip, and the port takes its windowed route (fixed-point
weights, a uint8 intermediate).  With flips it takes, on the card, the
float32-intermediate passes (float32 weights and products, a float32
intermediate, one rounding, the flip folded into the W tables), and on
the CPU the dense route (float32 matrix products, TF32 off): both the
crop in float32, rounded once.  The reference follows the route's
semantics (:mod:`perfbench.reference.crop`): the crop in real
arithmetic rounded once (``crop_dense``), or the windowed one at the
weight precision the configuration states (``windowed_route``).  The
controls are that reference one precision lower in one stage, put in
the port's place: TF32 products (flips) or 7-bit weights (windowed), or
a bfloat16 normalisation.
"""

from __future__ import annotations

import torch

from perfbench.harness import traffic as gen
from perfbench.reference import crop
from perfbench.reference.normalize import normalize


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from interpolate_antialiasing_tpu_torch.models import ImageNetTrainPipeline

        ctor = config["constructor"]
        self.preset = config["preset"]
        self.mean, self.std = self.preset["mean"], self.preset["std"]
        self.weight_bits = config["windowed_route"]["weight_bits"]
        self.pipe = ImageNetTrainPipeline(size=tuple(ctor["size"])).to(device)
        n = self.images_per_call = traffic["batch"]
        P = self.pool = traffic["pool"]
        self.shape = tuple(config["image"]["shape"])
        _, H, W = self.shape
        g = gen.generator(seed, device)
        self.x = gen.images(g, P, n, self.shape, device)
        self.boxes = gen.resized_crop_boxes(g, P * n, H, W, self.preset["scale"],
                                            self.preset["ratio"], device).reshape(P, n, 4)
        fl = gen.flips(g, P * n, traffic["hflip_prob"], device)
        self.flips = None if fl is None else fl.reshape(P, n)

    def _flip(self, k: int):
        return None if self.flips is None else self.flips[k]

    def call(self, i: int) -> torch.Tensor:
        k = i % self.pool
        return self.pipe.apply(self.x[k], self.boxes[k], self._flip(k))

    def release(self) -> None:
        """Drop the program's state; the inputs stay for the reference."""
        self.pipe = None

    def _levels(self, i: int, lower: bool, side: int = 0) -> torch.Tensor:
        k = i % self.pool
        size = self.preset["crop_size"]
        method = self.preset["interpolation"]
        if self.flips is not None:
            return crop.crop_dense(self.x[k], self.boxes[k], size, size, self.flips[k],
                                   method, tf32=lower, side=side)
        bits = 7 if lower else self.weight_bits
        return crop.crop_windowed(self.x[k], self.boxes[k], size, size, bits, bits, method,
                                  side)

    def reference(self, i: int) -> torch.Tensor:
        """The reference's grey levels of call ``i``'s batch, float64; where
        a pixel centre lies on a box edge, two readings stacked (the centre
        in, then out)."""
        _, H, W = self.shape
        if not crop.on_edge(self.boxes[i % self.pool], H, W):
            return self._levels(i, lower=False)
        return torch.stack([self._levels(i, False, side) for side in (-1, 1)])

    def controls(self) -> dict:
        """The reference one precision lower in one stage, put in the port's
        place: the crop (TF32 products where the traffic flips, 7-bit
        weights on the windowed route), or the normalisation (bfloat16)."""
        f32, bf16 = torch.float32, torch.bfloat16
        crop_name = "tf32_products" if self.flips is not None else "weights_7bit"
        return {crop_name: lambda i: normalize(self._levels(i, True), self.mean, self.std, f32),
                "bf16_normalise": lambda i: normalize(self._levels(i, False), self.mean, self.std,
                                                      bf16)}

    def essential_bytes(self, i: int) -> int:
        """Input bytes under each box, once, and the float32 output, once."""
        k = i % self.pool
        C, H, W = self.shape
        size = self.preset["crop_size"]
        return crop.box_bytes(self.boxes[k], H, W, C) + self.images_per_call * C * size * size * 4


def make(config: dict, traffic: dict, seed: int, device) -> Entry:
    return Entry(config, traffic, seed, device)
