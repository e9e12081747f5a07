"""interpolate_antialiasing_tpu_torch — the PyTorch / CUDA port of
``interpolate_antialiasing_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference; this package imports torch and numpy and
never jax.  Ported so far, the uint8 eval path and the float forward route:

  resize                 — the JAX package's resize: uint8 -> uint8
                           antialiased calls promoted to the Pillow-exact
                           route, every other route through the float kernels
  resize_plane           — separable resize of any two axes
  resize_nd              — one pass per axis over any axes
  interpolate            — torch.nn.functional.interpolate-shaped shim
  image_resize           — jax.image.resize-shaped shim
  resize_pil_exact       — Pillow's 8bpc two-pass resample, byte for byte
  ImageNetEvalPipeline   — uint8 batch -> resize -> normalised float (nn.Module)
  VideoDownscaler        — bf16 frames -> bf16 frames (nn.Module)

Three hand-written CUDA kernels (``csrc/``) run on CUDA tensors, their plain
PyTorch versions on CPU tensors: pil_resample_2pass (Pillow's integer
passes), resample2d (both float passes of a plane) and resample_axis (one
pass over any axis).

Environment dials, shared with the JAX package: IA_TPU_DEBUG, IA_TPU_BACKEND,
IA_TPU_PIL_DIGITS, IA_TPU_PRECISION.
"""

from .models import ImageNetEvalPipeline, VideoDownscaler
from .ops.pil_exact import resize_pil_exact
from .ops.resize import image_resize, interpolate, resize, resize_nd, resize_plane

__version__ = "0.1.0"

__all__ = ["resize", "resize_plane", "resize_nd", "interpolate", "image_resize",
           "resize_pil_exact", "ImageNetEvalPipeline", "VideoDownscaler",
           "__version__"]
