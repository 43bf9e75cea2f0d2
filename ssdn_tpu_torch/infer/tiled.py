"""Sequential tiled inference on one device (port of the single-device part
of ``ssdn_tpu/infer/tiled.py``).

An image too wide for one forward is denoised window by window: each
window is ``tile_w + 2*halo`` columns of the stride-32-padded image (the
whole image if narrower), clamped inside the image so that every conv's
zero padding lands at the true image edge, and only its middle ``tile_w``
columns are kept. The card holds one window's activations at a time, so
peak memory follows the window, not the image width.

The rotated branches run the causal-upward conv stack along the image's W
axis, so the horizontal reach is one-sided: 315 columns in the worst case
(``models.blindspot_unet.one_sided_causal_reach``). ``HALO_EXACT`` rounds
it up to 32, and a halo of at least that makes tiled equal untiled to fp32
summation order. Windows start on multiples of 32, so every pool and
upsample grid aligns with the untiled computation.

Each window runs through ``infer.full.make_denoise_fn``, exactly as an
untiled image does: the same forward, the same estimator, and for a
variable-blind model the noise level estimated over the window (as the JAX
package does in this mode). The sharded modes come with the parallel
slice of the port.
"""

from __future__ import annotations

import numpy as np

from ssdn_tpu_torch.config import TrainConfig
from ssdn_tpu_torch.infer.full import make_denoise_fn
from ssdn_tpu_torch.models import blindspot_unet
from ssdn_tpu_torch.utils.images import pad_to_multiple

# one-sided reach of the rotated causal branches, rounded up to 32: halos
# of at least this make tiling exact
HALO_EXACT = -(-blindspot_unet.one_sided_causal_reach() // 32) * 32


def tiled_denoise_sequential(
    cfg: TrainConfig,
    params,
    noisy: np.ndarray,
    noise_param,
    tile_w: int = 512,
    halo: int = HALO_EXACT,
    device=None,
) -> np.ndarray:
    """Denoise one (H, W, C) image (internal range) window by window on
    ``device`` (default cuda; raises without a GPU unless device="cpu")
    -> (H, W, C) numpy. ``params`` are the port's tensors on that device."""
    if tile_w % 32 or halo % 32:
        raise ValueError("tile_w and halo must be multiples of 32")
    fn = make_denoise_fn(cfg, device=device)
    padded, (h, w) = pad_to_multiple(noisy, blindspot_unet.STRIDE)
    pw = padded.shape[1]
    out = np.empty_like(padded)
    win = min(pw, tile_w + 2 * halo)
    for c0 in range(0, pw, tile_w):
        cw = min(tile_w, pw - c0)
        # one window width for every tile, clamped inside the image
        lo = min(max(0, c0 - halo), pw - win)
        res = fn(params, padded[None, :, lo:lo + win], noise_param)
        # the kept columns reach the host before the next window runs
        out[:, c0:c0 + cw] = res[0, :, c0 - lo:c0 - lo + cw].cpu().numpy()
    return out[:h, :w]
