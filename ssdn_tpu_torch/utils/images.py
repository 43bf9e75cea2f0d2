"""Image range conversions, PSNR, padding, and I/O (SURVEY.md §2.1
metrics/image-utils row). The PyTorch port's own copy of
``ssdn_tpu/utils/images.py``: numpy only, so PSNR and padding are
bit-identical on both sides.

Conventions: on-device tensors are NHWC float32 in the internal range
[-1/2, 1/2]; files and numpy interchange are uint8 [0, 255]. PSNR uses the
standard data-range-1 formula on [0, 1] images clipped after denoising.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np

try:  # Pillow is baked into the image; gate anyway per environment rules
    from PIL import Image

    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


def to_internal(u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1/2, 1/2]."""
    return u8.astype(np.float32) / 255.0 - 0.5


def from_internal(x: np.ndarray) -> np.ndarray:
    """float32 internal -> uint8 with clipping."""
    return np.clip((np.asarray(x, np.float32) + 0.5) * 255.0 + 0.5, 0, 255).astype(
        np.uint8
    )


def psnr(denoised, clean, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between internal-range images.

    Images are shifted to [0,1], the estimate clipped to the valid range
    (SURVEY.md §2.1 "PSNR on clamped [0,1] images"), and compared with the
    standard MSE formula.
    """
    d = np.clip(np.asarray(denoised, np.float64) + 0.5, 0.0, 1.0)
    c = np.clip(np.asarray(clean, np.float64) + 0.5, 0.0, 1.0)
    mse = float(np.mean((d - c) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * math.log10(data_range ** 2 / mse)


def pad_to_multiple(
    x: np.ndarray, multiple: int, square: bool = False,
    multiple_w: Optional[int] = None,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Reflect-pad (H, W, C) so H is a multiple of `multiple` and W of
    `multiple_w` (default: `multiple`); square=True also makes them equal
    (the single-batch rotation fold needs square inputs).
    Returns (padded, original (H, W)) for cropping back after inference
    (SURVEY.md §3.2 "pad image to satisfy U-Net stride-32 divisibility")."""
    h, w = x.shape[:2]
    mw = multiple_w or multiple
    ht = ((h + multiple - 1) // multiple) * multiple
    wt = ((w + mw - 1) // mw) * mw
    if square:
        ht = wt = max(ht, wt)
    pads = [(0, ht - h), (0, wt - w)] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, pads, mode="reflect"), (h, w)


def load_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Load an image file to uint8 HWC (C=1 for grayscale)."""
    if not _HAS_PIL:  # pragma: no cover
        raise RuntimeError("Pillow unavailable")
    img = Image.open(path)
    img = img.convert("L" if grayscale else "RGB")
    arr = np.asarray(img, np.uint8)
    if grayscale:
        arr = arr[..., None]
    return arr


def save_image(path: str, x: np.ndarray) -> None:
    """Save an internal-range or uint8 HWC array as an image file."""
    if not _HAS_PIL:  # pragma: no cover
        raise RuntimeError("Pillow unavailable")
    if x.dtype != np.uint8:
        x = from_internal(x)
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(x).save(path)


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm", ".tif", ".tiff")


def list_images(folder: str) -> List[str]:
    return sorted(
        os.path.join(folder, f)
        for f in os.listdir(folder)
        if f.lower().endswith(_IMG_EXTS)
    )
