"""Mixed-size batch resizing for serving and preprocessing (the port of
``interpolate_antialiasing_tpu.models.batch``).

BASELINE config 3, "batch-64 arbitrary-size -> 224x224", has images of
*different* sizes in one batch.  The kernels take one shape per launch, so
the images are grouped by shape (H, W), each group runs one resize call (on
the uint8 Pillow route, one ``pil_resample_2pass`` launch), and the results
are reassembled in input order.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence

import numpy as np
import torch

from ..ops.resize import resize

__all__ = ["resize_mixed_batch", "ShapeBucketResizer"]


def _device(device: torch.device | str | None) -> torch.device:
    """The device the images go to: the CUDA card unless ``device`` says
    otherwise (with no card, ``None`` raises)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the mixed-batch resizer runs on the CUDA card by default and none "
            "is available; pass device='cpu' to resize on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resize_mixed_batch(
    images: Sequence[np.ndarray | torch.Tensor],
    size: tuple[int, int],
    method: str = "bilinear",
    antialias: bool = True,
    data_format: str = "CHW",
    device: torch.device | str | None = None,
    **kw,
) -> torch.Tensor:
    """Resize a list of differently-sized images to one shape.

    ``images`` are host arrays (or tensors); each group of equal shapes is
    stacked, copied to ``device`` (the CUDA card by default) and resized in
    one call.  Returns a stacked ``[N, ...]`` tensor on ``device``, in the
    input order.  ``kw`` goes to :func:`..ops.resize.resize`.
    """
    if len(images) == 0:
        raise ValueError("resize_mixed_batch: need at least one image")
    dev = _device(device)
    buckets: dict[tuple, list[int]] = defaultdict(list)
    for i, im in enumerate(images):
        buckets[tuple(im.shape)].append(i)

    fmt = {"CHW": "NCHW", "HWC": "NHWC"}.get(data_format, data_format)
    out: list[torch.Tensor | None] = [None] * len(images)
    for idxs in buckets.values():
        batch = torch.stack([torch.as_tensor(images[i]) for i in idxs]).to(dev)
        y = resize(batch, size, method=method, antialias=antialias,
                   data_format=fmt, **kw)
        for k, i in enumerate(idxs):
            out[i] = y[k]
    return torch.stack(out)


class ShapeBucketResizer:
    """Stateful wrapper for serving loops that tracks the image shapes it
    has served.

    In the JAX package each new shape pays one compile; here the first call
    with a new shape builds that shape's host weight tables (cached per
    shape, uploaded once per device) and, on the card, the kernels on first
    use.  :meth:`warmup` does both ahead of traffic.
    """

    def __init__(self, size: tuple[int, int], method: str = "bilinear",
                 antialias: bool = True, data_format: str = "CHW",
                 device: torch.device | str | None = None, **kw):
        self.size = tuple(size)
        self.method = method
        self.antialias = antialias
        self.data_format = data_format
        self.device = _device(device)
        self.kw = kw
        self._seen_shapes: set[tuple] = set()

    def __call__(self, images: Sequence[np.ndarray | torch.Tensor]) -> torch.Tensor:
        for im in images:
            self._seen_shapes.add(tuple(im.shape))
        return resize_mixed_batch(
            images, self.size, self.method, self.antialias, self.data_format,
            self.device, **self.kw,
        )

    @property
    def shapes_compiled(self) -> int:
        """Distinct input shapes served (or warmed) so far."""
        return len(self._seen_shapes)

    def warmup(self, shapes: Sequence[tuple], dtype=np.uint8) -> int:
        """Run each input shape once, so no served batch pays for its tables
        or the kernels' build.  Returns the number of NEW shapes warmed."""
        new = 0
        for shp in shapes:
            shp = tuple(int(s) for s in shp)
            if shp in self._seen_shapes:
                continue
            self([np.zeros(shp, dtype)])
            new += 1
        return new
