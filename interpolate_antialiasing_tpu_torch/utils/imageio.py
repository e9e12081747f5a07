"""Test/benchmark image generation and PNG IO (a numpy-only copy of
``interpolate_antialiasing_tpu.utils.imageio``).

The reference ships a 906x438 photo (data/test.png).  We instead generate a
deterministic synthetic image of the same size with comparable spectral
content (smooth gradients + high-frequency texture + hard edges) so the
aliasing behaviour the library must suppress is actually present.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_image", "save_png", "load_png", "DEFAULT_HW"]

# Same H, W as the reference's data/test.png (906 wide, 438 tall).
DEFAULT_HW = (438, 906)


def synthetic_image(
    hw: tuple[int, int] = DEFAULT_HW, channels: int = 3, seed: int = 0
) -> np.ndarray:
    """Deterministic uint8 CHW test image with gradients, checkers, rings
    and noise — content that exposes aliasing on downsample."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u, v = xx / max(w - 1, 1), yy / max(h - 1, 1)
    rng = np.random.default_rng(seed)
    chans = []
    for c in range(channels):
        phase = 1.7 * c
        grad = 0.5 * u + 0.3 * v
        rings = 0.25 * np.sin(0.002 * ((xx - w / 3) ** 2 + (yy - h / 2) ** 2) + phase)
        checker = 0.15 * (((xx // (3 + c)) + (yy // (4 + c))) % 2)
        stripes = 0.15 * np.sin(2 * np.pi * (xx * (0.21 + 0.05 * c)))
        noise = 0.08 * rng.standard_normal((h, w))
        img = grad + rings + checker + stripes + noise
        chans.append(img)
    out = np.stack(chans, axis=0)
    out = (out - out.min()) / (out.max() - out.min())
    return (out * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, chw: np.ndarray) -> None:
    from PIL import Image

    arr = np.asarray(chw)
    if arr.ndim == 3:
        arr = np.transpose(arr, (1, 2, 0))
    Image.fromarray(arr).save(path)


def load_png(path: str) -> np.ndarray:
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"))
    return np.transpose(arr, (2, 0, 1))
