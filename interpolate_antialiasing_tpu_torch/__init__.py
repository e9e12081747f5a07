"""interpolate_antialiasing_tpu_torch — the PyTorch / CUDA port of
``interpolate_antialiasing_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference; this package imports torch and numpy and
never jax.  Ported so far, the byte-exact uint8 eval path:

  resize                 — uint8 -> uint8 antialiased resize, promoted to the
                           Pillow-exact route on every device
  resize_pil_exact       — Pillow's 8bpc two-pass resample, byte for byte;
                           one hand-written CUDA kernel
                           (csrc/pil_resample.cu) on CUDA tensors, its plain
                           PyTorch version on CPU tensors
  ImageNetEvalPipeline   — uint8 batch -> resize -> normalised float (nn.Module)

Environment dials, shared with the JAX package: IA_TPU_DEBUG, IA_TPU_BACKEND,
IA_TPU_PIL_DIGITS.
"""

from .models import ImageNetEvalPipeline
from .ops.pil_exact import resize_pil_exact
from .ops.resize import resize

__version__ = "0.1.0"

__all__ = ["resize", "resize_pil_exact", "ImageNetEvalPipeline", "__version__"]
