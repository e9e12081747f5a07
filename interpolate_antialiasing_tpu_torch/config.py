"""Library configuration and debug flags.

The same environment dials as ``interpolate_antialiasing_tpu.config``, under
the same names, so one environment drives both packages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

__all__ = ["ResizeOptions", "debug_enabled", "default_backend",
           "default_pil_digits", "default_precision", "enable_compilation_cache",
           "full_f32"]


def debug_enabled() -> bool:
    """IA_TPU_DEBUG=1 prints which kernel route fired."""
    return os.environ.get("IA_TPU_DEBUG", "0") not in ("0", "", "false")


def default_backend() -> str:
    """Override backend selection globally (IA_TPU_BACKEND, default auto)."""
    return os.environ.get("IA_TPU_BACKEND", "auto")


_PRECISIONS = ("split", "bf16", "f32")


def default_precision() -> str:
    """The kernels' precision dial (IA_TPU_PRECISION env), validated as the
    JAX package validates it: ``split`` (default), ``bf16`` or ``f32``.

    On the TPU the dial picks how many bf16 matrix-unit passes a float
    kernel spends per product.  The port's kernels multiply float32 weights
    into float32 sums at every setting, which is at least as precise as the
    TPU's ``split``: in the port the dial does nothing.  No kernel reads it;
    it is validated once, when this module is imported, so an unknown value
    raises there.
    """
    v = os.environ.get("IA_TPU_PRECISION", "split")
    if v not in _PRECISIONS:
        raise ValueError(f"IA_TPU_PRECISION={v!r}; expected one of {_PRECISIONS}")
    return v


default_precision()


@contextlib.contextmanager
def full_f32():
    """Full float32 matrix products on the card for the duration: TF32 off
    for cuBLAS and cuDNN, the previous settings restored after.  The JAX
    package runs its oracle routes at ``Precision.HIGHEST``; TF32 would keep
    about three decimal digits."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def default_pil_digits() -> int:
    """uint8 Pillow-exact accuracy dial (IA_TPU_PIL_DIGITS env):

      * ``3`` (default) — Pillow's pb=22 coefficient grid, byte-identical
        output.
      * ``2`` — the pb=14 grid: MaxAbsE <= 1 vs Pillow (admission-gated on
        tap count; wider windows run the exact grid).

    The name is the JAX package's, where the dial sets how many int8 digits
    its matrix-unit kernel splits each coefficient into.  The port's kernel
    multiplies the int32 coefficients directly, so here the dial only picks
    the coefficient grid; the bytes match the JAX package at either setting.
    Read per call; ``resize_pil_exact(digits=...)`` overrides it.
    """
    v = os.environ.get("IA_TPU_PIL_DIGITS", "3")
    if v not in ("2", "3"):
        raise ValueError(f"IA_TPU_PIL_DIGITS={v!r}; expected 2 or 3")
    return int(v)


@dataclasses.dataclass(frozen=True)
class ResizeOptions:
    """The keyword arguments of one ``resize`` call, bundled:
    ``resize(x, size, options=ResizeOptions(...))``."""

    method: str = "bilinear"
    antialias: bool = True
    align_corners: bool = False
    # None defers to the IA_TPU_BACKEND env override / "auto"
    backend: str | None = None
    data_format: str | None = None  # NCHW | NHWC | ... (None = infer)
    output_dtype: object = None


def enable_compilation_cache(path: str | None = None) -> str | None:
    """Keep the built libraries (the CUDA kernels of ``native.build`` and the
    host table builder) in ``path``, else in ``IA_TPU_COMPILE_CACHE``: the
    port's counterpart of the JAX package's persistent compilation cache.
    A later call, or a later process that calls this with the same
    directory, reuses what was built there for the same sources.  With
    neither set nothing changes: the libraries stay in the package's
    ``_build/``.  Only this call moves the build; the environment variable
    alone does not.  Returns the directory in use, or None."""
    cache_dir = path or os.environ.get("IA_TPU_COMPILE_CACHE")
    if not cache_dir:
        return None
    from . import native

    os.makedirs(cache_dir, exist_ok=True)
    native._use_build_dir(cache_dir)
    return cache_dir
