"""Tiled inference: sequential windows on one device, and the image's W axis
sharded over a process group (port of ``ssdn_tpu/infer/tiled.py``).

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
package does in this mode).

Sharded (``tiled_denoise_sharded``, over a ``parallel.Group``): the padded
image's W axis splits into one strip per rank, and every rank returns the
whole image (``all_gather_w``). Three strategies, all exact at the exact
halo:

  * per-level halo exchange (``infer/halo.py``): the torch-ops arm's
    blind-spot pipelines, strip-sized work at any width;
  * exchange (2*halo <= strip): one-hop ``ppermute`` messages bring the
    neighbours' context; every rank evaluates a window of strip + 2*halo
    columns, the two edge ranks' windows slid inside the image;
  * gather (2*halo > strip, or the window spans the image): every strip
    is gathered, and each rank cuts its clamped window from the image.

Each rank holds its own copy of the params (``broadcast_tree_`` makes them
rank 0's where they might differ), so nothing like the JAX package's
``_replicate_params`` is needed.
"""

from __future__ import annotations

import numpy as np

import torch

from ssdn_tpu_torch.config import TrainConfig
from ssdn_tpu_torch.infer.full import make_denoise_fn
from ssdn_tpu_torch.models import blindspot_unet
from ssdn_tpu_torch.parallel import Group, all_gather_w, ppermute
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


def make_exchange_fn(cfg: TrainConfig, group: Group, halo: int):
    """(params, strip (1, H, S, C) NHWC tensor, noise_vec) -> the rank's
    denoised strip, by ``ppermute`` halo exchange with clamped edge windows.

    Every rank evaluates a window of S + 2*halo columns and keeps its own
    strip. Interior ranks centre the window on their strip (one halo of
    real context per side); the two edge ranks slide it inside the image,
    so every conv's zero padding lands at the true image edge. Edge
    windows need up to 2*halo of one neighbour's context, so each rank
    ships two messages per direction: its edge halo (for the neighbour's
    centred window) and the columns just inside it (for an edge
    neighbour's slid window). Needs 2*halo <= S (``choose_mode``)."""
    n, idx = group.world, group.rank
    denoise = make_denoise_fn(cfg, device=group.device)
    fwd = [(i, (i + 1) % n) for i in range(n)]  # data moves left -> right
    bwd = [(i, (i - 1) % n) for i in range(n)]  # data moves right -> left

    def strip_fn(params, strip_data, noise_vec):
        strip = strip_data.shape[2]
        # centred-window context: my right edge -> right neighbour, etc.
        from_left = ppermute(strip_data[:, :, -halo:], fwd, group)
        from_right = ppermute(strip_data[:, :, :halo], bwd, group)
        # edge-window context: one halo further inside the neighbour
        extra_right = ppermute(strip_data[:, :, halo:2 * halo], bwd, group)
        extra_left = ppermute(
            strip_data[:, :, strip - 2 * halo:strip - halo], fwd, group)
        # my strip sits at window offset idx*S - clip(idx*S - halo, 0,
        # width - win) = 0 / halo / 2*halo for first / interior / last
        if idx == 0:
            parts, offset = [strip_data, from_right, extra_right], 0
        elif idx == n - 1:
            parts, offset = [extra_left, from_left, strip_data], 2 * halo
        else:
            parts, offset = [from_left, strip_data, from_right], halo
        out = denoise(params, torch.cat(parts, dim=2), noise_vec)
        return out[:, :, offset:offset + strip]

    return strip_fn


def make_gather_fn(cfg: TrainConfig, group: Group, halo: int, width: int):
    """All strips gathered, then each rank's clamped in-image window; exact,
    no fix-up."""
    n, idx = group.world, group.rank
    strip = width // n
    win = min(width, strip + 2 * halo)
    denoise = make_denoise_fn(cfg, device=group.device)

    def strip_fn(params, strip_data, noise_vec):
        full = all_gather_w(strip_data, group)
        start = min(max(idx * strip - halo, 0), width - win)
        out = denoise(params, full[:, :, start:start + win], noise_vec)
        return out[:, :, idx * strip - start:idx * strip - start + strip]

    return strip_fn


def choose_mode(halo: int, strip: int, width: int) -> str:
    """exchange needs the edge ranks' clamped windows (strip + 2*halo) to
    be coverable by one-hop neighbour context: 2*halo <= strip and the
    window inside the image."""
    if 2 * halo > strip or strip + 2 * halo >= width:
        return "gather"
    return "exchange"


def tiled_denoise_sharded(
    cfg: TrainConfig,
    params,
    noisy: np.ndarray,
    noise_param,
    group: Group,
    halo: int = HALO_EXACT,
    strategy: str = "auto",
) -> np.ndarray:
    """Denoise one (H, W, C) image (internal range) sharded over
    ``group``'s ranks, on ``group.device``; every rank passes the same
    image and ``params`` (the port's tensors on that device) and returns
    the whole denoised (H, W, C) numpy image.

    strategy:
      * "auto" (default): per-level halo exchange (``infer/halo.py``)
        whenever the config supports it (the torch-ops arm), else
        "window";
      * "perlevel": per-level, raising for the kernel arms;
      * "window": the clamped-window modes (``choose_mode`` picks
        exchange or gather; ``halo`` sets exactness).
    """
    if strategy not in ("auto", "perlevel", "window"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy != "window":
        from ssdn_tpu_torch.infer.halo import (
            perlevel_supported,
            tiled_denoise_perlevel,
        )

        if perlevel_supported(cfg):
            return tiled_denoise_perlevel(cfg, params, noisy, noise_param,
                                          group)
        if strategy == "perlevel":
            raise ValueError(
                "per-level halo exchange requires a blind-spot pipeline "
                "with lax conv/head backends"
            )
    if halo % 32:
        raise ValueError("halo must be a multiple of 32")
    n = group.world
    # H needs only stride-32 alignment; W also splits evenly over the ranks
    padded, (h, w) = pad_to_multiple(noisy, blindspot_unet.STRIDE,
                                     multiple_w=blindspot_unet.STRIDE * n)
    width = padded.shape[1]
    strip = width // n
    y = torch.as_tensor(padded[None, :, group.rank * strip:
                               (group.rank + 1) * strip], device=group.device)
    nv = torch.as_tensor(noise_param, dtype=torch.float32, device=group.device)
    if choose_mode(halo, strip, width) == "gather":
        fn = make_gather_fn(cfg, group, halo, width)
    else:
        fn = make_exchange_fn(cfg, group, halo)
    out = all_gather_w(fn(params, y, nv), group)
    return out[0, :h, :w].cpu().numpy()
