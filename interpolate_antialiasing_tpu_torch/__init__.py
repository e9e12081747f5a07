"""interpolate_antialiasing_tpu_torch — the PyTorch / CUDA port of
``interpolate_antialiasing_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference; this package imports torch and numpy and
never jax.  Ported so far, the serving paths and the training path:

  resize                 — the JAX package's resize: uint8 -> uint8
                           antialiased calls promoted to the Pillow-exact
                           route, every other route through the float kernels
  resize_plane           — separable resize of any two axes (differentiable)
  resize_nd              — one pass per axis over any axes (differentiable)
  interpolate            — torch.nn.functional.interpolate-shaped shim
  image_resize           — jax.image.resize-shaped shim
  resize_pil_exact       — Pillow's 8bpc two-pass resample, byte for byte
                           (with reducing_gap: PIL's reduce-then-resample)
  reduce_pil_exact       — PIL.Image.reduce, byte for byte
  scale_and_translate    — jax.image.scale_and_translate drop-in
  make_axis_spec, compute_tables, dense_matrix — the weight-table builders
  ResizeOptions          — resize's keyword arguments, bundled
  crop_and_resize        — per-image boxes, windowed kernel or dense route
  random_resized_crop    — antialiased RandomResizedCrop (torch.Generator)
  linear/nearest/cubic_forward, *_backward — the reference's op surface
  ImageNetEvalPipeline   — uint8 batch -> resize -> normalised float (nn.Module)
  ImageNetTrainPipeline  — uint8 batch -> RandomResizedCrop + flip -> normalised
  VideoDownscaler        — bf16 frames -> bf16 frames (nn.Module)
  models.ShapeBucketResizer, models.resize_mixed_batch — mixed-size batches
                           (BASELINE config 3), one call per shape
  models.aa_pyramid      — antialiased mip chains
  AAResize               — the resize as a parameter-free nn.Module
  Trainer, params_from_jax — the small resize + conv model's SGD loop (one
                           card, or a DeviceMesh: data x spatial sharding)
  parallel               — torch.distributed: make_mesh, shard_batch,
                           data_parallel_resize, halo-exchange resize_sharded
                           / resize_sharded_pil_exact / halo_resize_h,
                           dryrun_multichip

Autograd through every float resize is the exact adjoint (forward mode and
``torch.func.vmap`` too).  Five hand-written CUDA kernels (``csrc/``) run on
CUDA tensors, their plain PyTorch versions on CPU tensors:
pil_resample_2pass (Pillow's integer passes), resample2d (both float passes
of a plane, and of its adjoint), resample_axis (one pass over any axis, or
its adjoint, or a shard's H pass), crop_resample (the windowed crop's two
passes) and pil_resample_axis (one Pillow pass over any axis: the sharded
byte-exact route).  resample2d and resample_axis also synthesise their
weights in the kernel from the spec under ``fused=True``
(``ops.cuda_resize``), the JAX package's in-kernel weight route.

Environment dials, shared with the JAX package: IA_TPU_DEBUG, IA_TPU_BACKEND,
IA_TPU_PIL_DIGITS, IA_TPU_PRECISION.
"""

from .models import (
    AAResize,
    ImageNetEvalPipeline,
    ImageNetTrainPipeline,
    Trainer,
    VideoDownscaler,
    params_from_jax,
)
from .ops.api import (
    cubic_backward,
    cubic_forward,
    linear_backward,
    linear_forward,
    nearest_backward,
    nearest_forward,
)
from .config import ResizeOptions
from .ops.crop import crop_and_resize, random_resized_crop
from .ops.pil_exact import reduce_pil_exact, resize_pil_exact
from .ops.resize import image_resize, interpolate, resize, resize_nd, resize_plane
from .ops.scale_translate import scale_and_translate
from .ops.weights import compute_tables, dense_matrix, make_axis_spec
from . import parallel

__version__ = "0.1.0"

__all__ = ["resize", "interpolate", "resize_plane", "resize_nd", "image_resize",
           "scale_and_translate", "crop_and_resize", "random_resized_crop",
           "reduce_pil_exact", "resize_pil_exact",
           "linear_forward", "nearest_forward", "cubic_forward",
           "linear_backward", "nearest_backward", "cubic_backward",
           "make_axis_spec", "compute_tables", "dense_matrix", "ResizeOptions",
           "ImageNetEvalPipeline", "ImageNetTrainPipeline", "VideoDownscaler",
           "AAResize", "Trainer", "params_from_jax", "parallel", "__version__"]
