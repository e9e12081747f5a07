"""Adapter of ``VideoDownscaler``: torchvision's v2 ``Resize(size,
bilinear, antialias=True)`` on a batch of bfloat16 frames ``[N, C, H, W]``,
over a pool of seeded batches on the device.

The frames are uniform 8-bit levels from the seed
(:func:`perfbench.harness.traffic.images`), divided by 255 in float32 and
rounded once to bfloat16 (``ToDtype(scale=True)``), so they lie in [0, 1].
They are not normalised: ``mean`` 0 and ``std`` 1 per channel.  The port
is built from the configuration's ``constructor``; the reference
(:mod:`perfbench.reference.video`) takes the output size from it too, and
nothing else of the port.  The controls are the port's own paths, each
one stage one precision lower: a bfloat16 intermediate between its two
passes, and its weights rounded to bfloat16.
"""

from __future__ import annotations

import torch

from perfbench.harness import traffic as gen
from perfbench.reference import video


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from interpolate_antialiasing_tpu_torch.models import VideoDownscaler

        ctor = config["constructor"]
        self.size = tuple(ctor["size"])
        self.method = ctor["method"]
        self.model = VideoDownscaler(out_hw=self.size, method=self.method,
                                     backend=ctor["backend"])
        self.images_per_call = traffic["batch"]
        self.pool = traffic["pool"]
        self.shape = tuple(config["image"]["shape"])
        C = self.shape[0]
        self.mean, self.std = [0.0] * C, [1.0] * C
        g = gen.generator(seed, device)
        levels = gen.images(g, self.pool, self.images_per_call, self.shape, device)
        self.x = torch.empty(levels.shape, dtype=torch.bfloat16, device=device)
        for k in range(self.pool):  # a frame at a time: a float32 pool would not fit
            for n in range(self.images_per_call):
                self.x[k, n] = (levels[k, n].to(torch.float32) / 255).to(torch.bfloat16)

    def call(self, i: int) -> torch.Tensor:
        return self.model(self.x[i % self.pool])

    def release(self) -> None:
        """Drop the program's state; the inputs stay for the reference."""
        self.model = None

    def reference(self, i: int) -> torch.Tensor:
        """The exact values of call ``i``'s output, float64 ``[N, C, oh, ow]``."""
        return video.downscale(self.x[i % self.pool], *self.size, self.method)

    def _specs(self):
        from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec

        _, H, W = self.shape
        oh, ow = self.size
        return make_axis_spec(H, oh, self.method), make_axis_spec(W, ow, self.method)

    def _bf16_intermediate(self, i: int) -> torch.Tensor:
        from interpolate_antialiasing_tpu_torch.ops.cuda_resize import resize_axis

        spec_h, spec_w = self._specs()
        y = resize_axis(self.x[i % self.pool], spec_w, -1, torch.bfloat16)
        return resize_axis(y, spec_h, -2, torch.bfloat16)

    def controls(self) -> dict:
        """The port's own paths, one stage each one precision lower: its two
        axis passes, W then H, with a bfloat16 intermediate; and its
        two-pass kernel over the same passes' tables with each weight
        rounded to bfloat16."""
        from interpolate_antialiasing_tpu_torch.ops.cuda_resize import resize2d
        from interpolate_antialiasing_tpu_torch.ops.weights import Tables, forward_tables

        def bf16_tables(spec):
            t = forward_tables(spec)
            w = torch.tensor(t.w).to(torch.bfloat16).to(torch.float64).numpy()
            w.setflags(write=False)
            return Tables(t.in_size, t.out_size, t.xmin, w)

        th, tw = (bf16_tables(s) for s in self._specs())
        return {"bf16_intermediate": self._bf16_intermediate,
                "bf16_weights": lambda i: resize2d(self.x[i % self.pool], th, tw,
                                                   torch.bfloat16)}

    def essential_bytes(self, i: int) -> int:
        """The frames read once and the bfloat16 output written once."""
        C, H, W = self.shape
        oh, ow = self.size
        return self.images_per_call * C * (H * W + oh * ow) * 2


def make(config: dict, traffic: dict, seed: int, device) -> Entry:
    return Entry(config, traffic, seed, device)
