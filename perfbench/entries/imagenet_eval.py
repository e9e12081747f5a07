"""Adapter of ``ImageNetEvalPipeline``: torchvision's ImageNet eval preset
(Resize(short side) on the byte-exact Pillow route, CenterCrop, ToTensor,
Normalize) over a pool of seeded uint8 batches on the device.

The port is built from the configuration's ``constructor``; the reference
from its ``preset`` alone (:mod:`perfbench.reference.pillow`, the centre
crop's arithmetic as torchvision's, :mod:`perfbench.reference.normalize`).
The controls are the port's own lower-precision paths: Pillow's weights
on the 14-bit grid (``IA_TPU_PIL_DIGITS=2``), and a bfloat16 output.
"""

from __future__ import annotations

import os

import torch

from perfbench.harness import traffic as gen
from perfbench.reference import pillow


def _resized_size(h: int, w: int, short: int) -> tuple[int, int]:
    """torchvision ``Resize(int)``: the short side to ``short``, the long
    side ``int(short * long / short_side)``."""
    if h <= w:
        return short, int(short * w / h)
    return int(short * h / w), short


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from interpolate_antialiasing_tpu_torch.models import ImageNetEvalPipeline

        ctor = config["constructor"]
        self.preset = config["preset"]
        self.mean, self.std = self.preset["mean"], self.preset["std"]
        self._ctor = dict(size=tuple(ctor["size"]), short_side=ctor["short_side"],
                          resize_domain=ctor["resize_domain"])
        self.pipe = ImageNetEvalPipeline(**self._ctor).to(device)
        self.images_per_call = traffic["batch"]
        self.pool = traffic["pool"]
        self.shape = tuple(config["image"]["shape"])
        g = gen.generator(seed, device)
        self.x = gen.images(g, self.pool, self.images_per_call, self.shape, device)

    def call(self, i: int) -> torch.Tensor:
        return self.pipe(self.x[i % self.pool])

    def release(self) -> None:
        """Drop the program's state; the inputs stay for the reference."""
        self.pipe = None

    def _geometry(self):
        _, H, W = self.shape
        rh, rw = _resized_size(H, W, self.preset["resize_size"])
        ch = cw = self.preset["crop_size"]
        # torchvision center_crop: int(round(d / 2.0)), half to even
        return H, W, rh, rw, ch, cw, int(round((rh - ch) / 2.0)), int(round((rw - cw) / 2.0))

    def reference(self, i: int) -> torch.Tensor:
        """The reference's grey levels of call ``i``'s batch, float64."""
        _, _, rh, rw, ch, cw, top, left = self._geometry()
        y = pillow.resize(self.x[i % self.pool], rh, rw, self.preset["interpolation"])
        return y[..., top:top + ch, left:left + cw]

    def _program(self, i: int, digits: str, dtype) -> torch.Tensor:
        from interpolate_antialiasing_tpu_torch.models import ImageNetEvalPipeline

        pipe = ImageNetEvalPipeline(**self._ctor, dtype=dtype).to(self.x.device)
        prev = os.environ.get("IA_TPU_PIL_DIGITS")
        os.environ["IA_TPU_PIL_DIGITS"] = digits
        try:
            return pipe(self.x[i % self.pool])
        finally:
            if prev is None:
                del os.environ["IA_TPU_PIL_DIGITS"]
            else:
                os.environ["IA_TPU_PIL_DIGITS"] = prev

    def controls(self) -> dict:
        """The port's own lower-precision paths, one stage each: Pillow's
        weights on the 14-bit grid, and a bfloat16 output."""
        return {"pil_14bit": lambda i: self._program(i, "2", torch.float32),
                "bf16_output": lambda i: self._program(i, "3", torch.bfloat16)}

    def essential_bytes(self, i: int) -> int:
        """Input bytes the kept outputs read (the rows and columns under the
        centre crop's taps), once, and the float32 output, once."""
        H, W, rh, rw, ch, cw, top, left = self._geometry()
        method = self.preset["interpolation"]
        rows = pillow.kept_input_span(H, rh, top, ch, method)
        cols = pillow.kept_input_span(W, rw, left, cw, method)
        C = self.shape[0]
        return self.images_per_call * C * (rows * cols + ch * cw * 4)


def make(config: dict, traffic: dict, seed: int, device) -> Entry:
    return Entry(config, traffic, seed, device)
