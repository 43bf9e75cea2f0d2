"""Clean images made from the run's seed.

``training_corpus`` is a frozen copy of the port's procedural generator
(``ssdn_tpu_torch/data/synthetic.py``: smooth multi-scale random fields
plus random rectangles and disks), numpy only, so the same seed gives the
same uint8 corpus on any host. ``photos`` makes serving-size clean images
of the same kind on the device with a ``torch.Generator``, in a few large
calls, and brings them to the host as the float32 arrays a caller hands to
the denoiser.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _smooth_field(rng: np.random.Generator, size: int, channels: int):
    acc = np.zeros((size, size, channels), np.float32)
    amp, total, res = 1.0, 0.0, 4
    while res <= size:
        coarse = rng.standard_normal((res, res, channels)).astype(np.float32)
        idx = np.linspace(0, res - 1, size)
        i0 = np.floor(idx).astype(int)
        i1 = np.minimum(i0 + 1, res - 1)
        t = (idx - i0).astype(np.float32)
        rows = coarse[i0] * (1 - t)[:, None, None] + coarse[i1] * t[:, None, None]
        up = rows[:, i0] * (1 - t)[None, :, None] + rows[:, i1] * t[None, :, None]
        acc += amp * up
        total += amp
        amp *= 0.55
        res *= 2
    acc /= total
    return (acc - acc.min()) / (np.ptp(acc) + 1e-6)


def _add_shapes(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
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


def _image(seed: int, i: int, size: int, channels: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
    img = _add_shapes(rng, _smooth_field(rng, size, channels))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def training_corpus(seed: int, n: int, size: int,
                    channels: int = 3) -> List[np.ndarray]:
    """n uint8 (size, size, channels) images; image i from
    SeedSequence([seed, i]), made on a few threads (numpy releases the
    interpreter lock in its array passes)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(lambda i: _image(seed, i, size, channels),
                           range(n)))


def photos(seed: int, shapes: Sequence[Tuple[int, int]], sigmas_255,
           device) -> List[Tuple[np.ndarray, float]]:
    """One noisy float32 (H, W, 3) image in [-1/2, 1/2] + noise per shape,
    with its noise sigma (in those units): a smooth random field of six
    octaves plus three to five flat rectangles, quantised to 8 bits, then
    Gaussian noise of sigma_255 / 255."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    out = []
    for (h, w), s255 in zip(shapes, sigmas_255):
        acc = torch.zeros((1, 3, h, w), device=device)
        amp, total = 1.0, 0.0
        for octave in range(6):
            res = 4 * 2 ** octave
            coarse = torch.randn((1, 3, res, res), generator=g, device=device)
            acc += amp * F.interpolate(coarse, size=(h, w), mode="bilinear",
                                       align_corners=True)
            total += amp
            amp *= 0.55
        acc = acc / total
        acc = (acc - acc.amin()) / (acc.amax() - acc.amin() + 1e-6)
        box = torch.rand((5, 7), generator=g, device=device)
        n_box = 3 + int(box[0, 0] * 3)
        for r in box[:n_box]:
            r0, c0 = int(r[0] * h), int(r[1] * w)
            r1 = r0 + int(h * (0.1 + 0.4 * float(r[2])))
            c1 = c0 + int(w * (0.1 + 0.4 * float(r[3])))
            acc[:, :, r0:r1, c0:c1] = r[4:7].view(1, 3, 1, 1)
        clean = torch.round(acc.clamp(0, 1) * 255) / 255 - 0.5
        sigma = float(s255) / 255.0
        noisy = clean + sigma * torch.randn(clean.shape, generator=g,
                                            device=device)
        out.append((noisy[0].permute(1, 2, 0).contiguous().cpu().numpy(),
                    sigma))
    return out
