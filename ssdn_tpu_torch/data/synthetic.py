"""Procedural clean-image source (the PyTorch port's own copy of
``ssdn_tpu/data/synthetic.py``; numpy only, so its images are the JAX
package's, bit for bit).

Tests, benches and the out-of-the-box demo path use procedurally generated
"natural-ish" images: smooth multi-scale random fields plus random
geometric shapes — enough structure that denoising PSNR is meaningful. Real corpora (BSDS300,
Kodak, ...) plug in through the folder / HDF5 datasets in datasets.py.
"""

from __future__ import annotations

import numpy as np


def _smooth_field(rng: np.random.Generator, size: int, channels: int) -> np.ndarray:
    """Sum of bilinearly-upsampled noise octaves -> (size, size, C) in [0,1]."""
    acc = np.zeros((size, size, channels), np.float32)
    amp, total = 1.0, 0.0
    res = 4
    while res <= size:
        coarse = rng.standard_normal((res, res, channels)).astype(np.float32)
        # bilinear upsample to full size via np broadcasting
        idx = np.linspace(0, res - 1, size)
        i0 = np.floor(idx).astype(int)
        i1 = np.minimum(i0 + 1, res - 1)
        t = (idx - i0).astype(np.float32)
        rows = (
            coarse[i0] * (1 - t)[:, None, None] + coarse[i1] * t[:, None, None]
        )
        up = (
            rows[:, i0] * (1 - t)[None, :, None]
            + rows[:, i1] * t[None, :, None]
        )
        acc += amp * up
        total += amp
        amp *= 0.55
        res *= 2
    acc /= total
    acc = (acc - acc.min()) / (np.ptp(acc) + 1e-6)
    return acc


def _add_shapes(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Paint a few random constant-color rectangles/disks (sharp edges)."""
    size = img.shape[0]
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(int(rng.integers(2, 6))):
        color = rng.uniform(0, 1, img.shape[-1]).astype(np.float32)
        if rng.uniform() < 0.5:
            r0, c0 = rng.integers(0, size, 2)
            h, w = rng.integers(size // 8, size // 2, 2)
            mask = (yy >= r0) & (yy < r0 + h) & (xx >= c0) & (xx < c0 + w)
        else:
            cy, cx = rng.integers(0, size, 2)
            rad = int(rng.integers(size // 10, size // 3))
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < rad ** 2
        blend = rng.uniform(0.5, 1.0)
        img[mask] = (1 - blend) * img[mask] + blend * color
    return img


def make_images(
    n: int, size: int = 128, channels: int = 3, seed: int = 0
) -> list:
    """n uint8 (size, size, channels) procedural images, deterministic."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        img = _smooth_field(rng, size, channels)
        img = _add_shapes(rng, img)
        out.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return out
