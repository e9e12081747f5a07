"""Image preprocessing pipelines built on the AA resize op (the port of
``interpolate_antialiasing_tpu.models.preprocess``):

  * the ImageNet-eval pipeline (batch-N arbitrary -> 224x224 bilinear AA,
    then cast and normalisation), in the uint8 or the float32 domain;
  * the ImageNet-train pipeline (antialiased RandomResizedCrop with the
    random horizontal flip folded in, then normalisation);
  * the bf16 video downscaler (3840x2160 -> 1920x1080, BASELINE config 5).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.crop import box_fracs, crop_and_resize, sample_boxes
from ..ops.normalize import normalize
from ..ops.resize import resize, resize_plane
from ..utils.trace import span, spanned

__all__ = ["ImageNetEvalPipeline", "ImageNetTrainPipeline", "VideoDownscaler",
           "imagenet_eval_preprocess"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class ImageNetEvalPipeline(nn.Module):
    """uint8 NCHW batch -> normalised float NCHW at ``size``.

    Mirrors torchvision eval preprocessing (Resize with antialias=True).
    ``resize_domain="uint8"`` (the default) resizes the uint8 image first
    through the byte-exact Pillow kernel and normalises the quantised
    result — exactly what torchvision's PIL-backend transform stack computes
    (PIL resize -> ToTensor -> Normalize).  ``"float32"`` resizes in float
    (the two-pass resample2d kernel): fractionally more precise than the
    standard pipeline, but not equal to it.  ``short_side=256`` gives
    torchvision's canonical Resize(256) + CenterCrop(size); None resizes
    directly to ``size``.

    ``mean`` and ``std`` are float32 buffers of shape ``[1, C, 1, 1]``; the
    pipeline runs on the device of its input.  Both pipelines normalise
    through :func:`..ops.normalize.normalize`: on a CUDA tensor one
    hand-written kernel reads the (centre-cropped) resize once and writes
    the output once, equal bit for bit to the plain expression.
    """

    def __init__(
        self,
        size: tuple[int, int] = (224, 224),
        method: str = "bilinear",
        antialias: bool = True,
        dtype: torch.dtype = torch.float32,
        mean: Sequence[float] = _IMAGENET_MEAN,
        std: Sequence[float] = _IMAGENET_STD,
        resize_domain: str = "uint8",
        short_side: int | None = None,
    ):
        super().__init__()
        self.size = tuple(size)
        self.method = method
        self.antialias = antialias
        self.dtype = dtype
        self.resize_domain = resize_domain
        self.short_side = short_side
        self.register_buffer(
            "mean", torch.tensor(mean, dtype=torch.float32).reshape(1, -1, 1, 1))
        self.register_buffer(
            "std", torch.tensor(std, dtype=torch.float32).reshape(1, -1, 1, 1))

    def _resize(self, x: torch.Tensor, hw) -> torch.Tensor:
        if x.dtype == torch.uint8:
            # float32 domain: the kernel widens uint8 itself (exactly), with
            # no float32 copy of the batch
            out = None if self.resize_domain == "uint8" else torch.float32
            return resize(x, hw, method=self.method, antialias=self.antialias,
                          output_dtype=out)
        return resize_plane(
            x.to(torch.float32), hw, h_axis=-2, w_axis=-1,
            mode=self.method, antialias=self.antialias,
        )

    @spanned("ia.models.eval")
    def forward(self, batch_u8: torch.Tensor) -> torch.Tensor:
        if self.short_side is not None:
            H, W = batch_u8.shape[-2], batch_u8.shape[-1]
            s = self.short_side
            # torchvision Resize(int): short side -> s, long side TRUNCATED
            # (_compute_resized_output_size uses int(size * long / short))
            if H <= W:
                rh, rw = s, max(1, int(s * W / H))
            else:
                rh, rw = max(1, int(s * H / W)), s
            oh, ow = self.size
            if oh > rh or ow > rw:
                raise ValueError(
                    f"CenterCrop {self.size} exceeds the resized image "
                    f"({rh}, {rw}); torchvision would zero-pad here — pick "
                    "a smaller crop or larger short_side"
                )
            y = self._resize(batch_u8, (rh, rw))
            # torchvision center_crop: int(round(d / 2.0)) — Python
            # round-half-to-even, NOT floor
            top = int(round((rh - oh) / 2.0))
            left = int(round((rw - ow) / 2.0))
            y = y[..., top : top + oh, left : left + ow]
        else:
            y = self._resize(batch_u8, self.size)
        with span("ia.models.normalize"):
            return normalize(y, self.mean, self.std, self.dtype)


def imagenet_eval_preprocess(batch_u8: torch.Tensor, size=(224, 224)) -> torch.Tensor:
    return ImageNetEvalPipeline(size=size)(batch_u8)


class ImageNetTrainPipeline(nn.Module):
    """uint8 NCHW batch -> augmented normalised float NCHW at ``size``.

    The train-time counterpart of :class:`ImageNetEvalPipeline`:
    antialiased RandomResizedCrop (``scale``, ``ratio``) with a random
    horizontal flip (probability ``flip_prob``) folded into the crop's W
    weights, the crop kept in uint8 (the Pillow-backend torchvision
    transform's convention), then ``/255``, ``-mean``, ``/std``.  Because
    it passes ``flip``, the crop takes the float32 windowed route on a CUDA
    tensor (the dense route's float32 arithmetic over each row's nonzero
    taps) and the dense route on the CPU, as in the JAX package.
    ``forward(generator, batch_u8)`` draws the boxes and flips
    from ``generator`` (:meth:`sample`) and applies them (:meth:`apply`).
    """

    def __init__(
        self,
        size: tuple[int, int] = (224, 224),
        method: str = "bilinear",
        scale: tuple[float, float] = (0.08, 1.0),
        ratio: tuple[float, float] = (0.75, 4.0 / 3.0),
        flip_prob: float = 0.5,
        dtype: torch.dtype = torch.float32,
        mean: Sequence[float] = _IMAGENET_MEAN,
        std: Sequence[float] = _IMAGENET_STD,
    ):
        super().__init__()
        self.size = tuple(size)
        self.method = method
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.flip_prob = flip_prob
        self.dtype = dtype
        self.register_buffer(
            "mean", torch.tensor(mean, dtype=torch.float32).reshape(1, -1, 1, 1))
        self.register_buffer(
            "std", torch.tensor(std, dtype=torch.float32).reshape(1, -1, 1, 1))

    def sample(self, generator: torch.Generator | None, batch_u8: torch.Tensor):
        """``(boxes [N, 4], flip [N] bool)`` for a batch, from
        ``generator`` (on its own device), moved to the batch's device."""
        N, _, H, W = batch_u8.shape
        boxes = sample_boxes(generator, N, H, W, self.scale, self.ratio,
                             device=batch_u8.device)
        gdev = generator.device if generator is not None else torch.device("cpu")
        flip = torch.rand(N, generator=generator, device=gdev) < self.flip_prob
        return boxes, flip.to(batch_u8.device)

    @spanned("ia.models.train")
    def apply(self, batch_u8: torch.Tensor, boxes: torch.Tensor,
              flip: torch.Tensor) -> torch.Tensor:
        """Crop, resize and flip with the given boxes and flips, then
        normalise."""
        H, W = batch_u8.shape[-2:]
        y = crop_and_resize(
            batch_u8, boxes, self.size, method=self.method, flip=flip,
            max_box_frac=box_fracs(H, W, self.scale, self.ratio),
        )
        with span("ia.models.normalize"):
            return normalize(y, self.mean, self.std, self.dtype)

    def forward(self, generator: torch.Generator | None,
                batch_u8: torch.Tensor) -> torch.Tensor:
        return self.apply(batch_u8, *self.sample(generator, batch_u8))


class VideoDownscaler(nn.Module):
    """bf16 frame downscaler: ``[N, C, H, W]`` -> ``[N, C, oh, ow]``.

    float32 weight tables with bf16 frames, float32 sums, bf16 out.  The
    default ``backend="pallas"`` runs the two-pass resample2d kernel on a
    CUDA tensor (its plain version on a CPU tensor); None defers to the
    IA_TPU_BACKEND dial / ``auto``, which routes the same way.
    """

    def __init__(self, out_hw: tuple[int, int] = (1080, 1920),
                 method: str = "bilinear", backend: str | None = "pallas"):
        super().__init__()
        self.out_hw = tuple(out_hw)
        self.method = method
        self.backend = backend

    @spanned("ia.models.video")
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        y = resize_plane(
            frames.to(torch.bfloat16),
            self.out_hw,
            h_axis=-2,
            w_axis=-1,
            mode=self.method,
            backend=self.backend,
        )
        return y.to(torch.bfloat16)
