"""Per-level halo exchange: exact sharded tiled inference at real image sizes
(port of ``ssdn_tpu/infer/halo.py``).

The clamped-window modes in ``infer/tiled.py`` ship a 320-column halo in one
exchange before the forward, so they only beat gathering the whole image
when it is wider than ``n * 2 * 320`` px. This module exchanges context
inside the trunk instead: a <=2-column halo per convolution at that
convolution's resolution, so every rank computes a strip-sized window at
every level, whatever the image width. Communication is ~60 one-hop
``ppermute`` messages per image. The halo columns and rows are small (a
few KB to a few hundred KB each); the two reversals that hand the rotated
branches' trunk outputs back are not: each carries a whole 96-channel
strip (about 302 MB per rank in bf16 for a 2048x1536 image over two
ranks), and together they are almost all of the traffic.

Design (every rank runs the same program on its own W-strip, over a
``parallel.Group``):

  * Each rotated branch's input is assembled rank-locally: rot180/rot90 of
    a W-sharded image is (local rotation) + (rank-order reversal), so one
    reversal ``ppermute`` plus local ``rot90`` gives all four branch
    strips.
  * Branches rot0/rot180 run the trunk in **W-mode**: the sharded axis is
    the tensor's W, so each 3x3 conv needs one column per side. Pool and
    upsample windows are 32-aligned and never cross ranks; the causal (H)
    axis is local.
  * Branches rot90/rot270 run in **H-mode**: the sharded axis is the
    tensor's causal H, so each conv needs 2 rows from the lower-rank
    neighbour only (the shifted conv reads rows <= r), the offset pool 1
    row, the final blind-spot shift 1 row.
  * ``ppermute`` delivers zeros to a rank with no source, which is the
    untiled conv's zero padding at the true image edge; only the offset
    pool's -inf fill needs an explicit fix on rank 0.
  * The 1x1 head and the posterior mean are pixel-local. Blind noise
    estimates are image-global spatial means, so the per-strip means are
    ``pmean``'d over the ranks before the estimator runs (strips are equal
    width, so the mean of the strip means is the image mean).

The trunk is the literal pool(lrelu(conv)) / upsample->concat->conv
program in torch ops (as in the JAX package: the kernel arms use the
window modes), its convs at the port's precision contract
(``ops.shifted``: fp32 with TF32 off). Tensors are NCHW inside, as in
``models.blindspot_unet``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ssdn_tpu_torch import estimator
from ssdn_tpu_torch.config import NoiseModel, NoiseValue, Pipeline, TrainConfig
from ssdn_tpu_torch.estimator.core import _ALPHA_HI, _ALPHA_LO, _softplus
from ssdn_tpu_torch.infer.full import runtime_noise_params
from ssdn_tpu_torch.models.blindspot_unet import STRIDE
from ssdn_tpu_torch.ops import leaky_relu, rot90, upsample_2x_nearest
from ssdn_tpu_torch.ops.shifted import (
    _conv_valid,
    matmul_acc_f32,
    maxpool_2x2,
    shifted_maxpool_2x2,
)
from ssdn_tpu_torch.parallel import Group, all_gather_w, pmean, ppermute
from ssdn_tpu_torch.utils.images import pad_to_multiple


def _fwd(n):  # to the higher rank; rank 0 receives zeros (image edge)
    return [(i, i + 1) for i in range(n - 1)]


def _bwd(n):  # to the lower rank; rank n-1 receives zeros
    return [(i + 1, i) for i in range(n - 1)]


def _rev(n):  # rank-order reversal (rotated-branch strip assembly)
    return [(i, n - 1 - i) for i in range(n)]


def _conv(x, w, b, hpad, wpad, precision):
    """3x3 (or 1x1) conv with explicit (top, bottom) / (left, right)
    padding, the halos already in ``x`` on the sharded axis; the dtype and
    precision contract of ``ops.conv2d``."""
    xp = F.pad(x, (wpad[0], wpad[1], hpad[0], hpad[1]))
    out = _conv_valid(xp, w.to(x.dtype), precision)
    return out + b.to(out.dtype).view(1, -1, 1, 1)


def _branch_w(params, x, group: Group, precision):
    """Trunk in W-mode: sharded axis = tensor W. Each conv swaps one
    column per side; everything else is local."""
    n = group.world

    def conv(name, h):
        p = params[name]
        left = ppermute(h[..., -1:], _fwd(n), group)
        right = ppermute(h[..., :1], _bwd(n), group)
        he = torch.cat([left, h, right], dim=3)
        return leaky_relu(_conv(he, p["w"], p["b"], (2, 0), (0, 0),
                                precision))

    # the offset pool runs along the local causal axis; W windows are
    # 2-aligned inside the 32-multiple strip, so no W halo is needed
    return _trunk(params, x, conv, shifted_maxpool_2x2)


def _branch_h(params, x, group: Group, precision):
    """Trunk in H-mode: sharded axis = tensor H = the causal axis. Convs
    pull 2 rows, the offset pool 1 row, from the lower-rank neighbour."""
    n = group.world

    def conv(name, h):
        p = params[name]
        if h.shape[2] >= 2:
            top = ppermute(h[:, :, -2:], _fwd(n), group)
        else:
            # deepest level with strip == STRIDE: local H is 1, so the
            # 2-row history spans TWO neighbours — the second row comes
            # 2 hops (ranks 0 and 1 get zeros = image edge)
            near = ppermute(h[:, :, -1:], _fwd(n), group)
            far = ppermute(h[:, :, -1:], [(i, i + 2) for i in range(n - 2)],
                           group)
            top = torch.cat([far, near], dim=2)
        he = torch.cat([top, h], dim=2)
        return leaky_relu(_conv(he, p["w"], p["b"], (0, 0), (1, 1),
                                precision))

    def pool(h):
        top = ppermute(h[:, :, -1:], _fwd(n), group)
        if group.rank == 0:
            # the untiled offset pool's virtual row is -inf; ppermute's
            # edge fill is zeros, which could win the max over negative
            # activations
            top = torch.full_like(top, float("-inf"))
        return maxpool_2x2(torch.cat([top, h[:, :, :-1]], dim=2))

    return _trunk(params, x, conv, pool)


def _trunk(params, x, conv, pool):
    """The literal U-Net program over mode-specific conv / pool."""
    skips = [x]
    h = pool(conv("enc1", conv("enc0", x)))
    skips.append(h)
    for i in (2, 3, 4):
        h = pool(conv(f"enc{i}", h))
        skips.append(h)
    h = pool(conv("enc5", h))
    h = conv("enc6", h)
    for stage, skip in zip((5, 4, 3, 2, 1), reversed(skips)):
        h = upsample_2x_nearest(h)
        h = torch.cat([h, skip.to(h.dtype)], dim=1)
        h = conv(f"dec{stage}a", h)
        h = conv(f"dec{stage}b", h)
    return h


def _shift_down_h(x, group: Group):
    """Blind-spot +1 px shift when the causal axis is sharded: 1 row from
    the lower-rank neighbour (zeros at the image edge, shift_down's
    fill)."""
    top = ppermute(x[:, :, -1:], _fwd(group.world), group)
    return torch.cat([top, x[:, :, :-1]], dim=2)


def _blind_eval_cfg(noise, out, c, group: Group):
    """Image-global blind noise estimate under sharding: pmean the
    per-strip spatial mean, then hand the estimator a KNOWN config whose
    parameter is the estimate (the BLIND posterior closed forms are the
    KNOWN ones at the estimated parameter)."""
    t = c * (c + 1) // 2
    noise_ch = out[..., c + t]
    known = dataclasses.replace(noise, value=NoiseValue.KNOWN)
    if noise.model == NoiseModel.IMPULSE:
        m = pmean(torch.mean(torch.sigmoid(noise_ch), dim=(1, 2)), group)
        return known, {"alpha": _ALPHA_LO + (_ALPHA_HI - _ALPHA_LO) * m}
    s = pmean(torch.mean(_softplus(noise_ch), dim=(1, 2)), group)
    if noise.model == NoiseModel.POISSON:
        # var_blind = max(mu+1/2, 1e-3) * 2 s^2 == var_known at lam = 0.5/s^2
        return known, {"lam": 0.5 / (s * s)}
    return known, {"sigma": s}


def perlevel_supported(cfg: TrainConfig) -> bool:
    """The per-level program implements the blind-spot forward in the
    torch-ops arm; other pipelines and the kernel arms use the
    clamped-window modes."""
    return (
        cfg.pipeline in (Pipeline.SSDN, Pipeline.SSDN_MSE)
        and cfg.model.conv_backend == "lax"
        and cfg.model.head_backend == "lax"
    )


def make_per_level_fn(cfg: TrainConfig, group: Group):
    """(params, strip (1, H, W/n, C) NHWC tensor on ``group.device``,
    noise_vec) -> the denoised strip, every rank holding one strip end to
    end. Runs under ``torch.inference_mode``."""
    if cfg.pipeline not in (Pipeline.SSDN, Pipeline.SSDN_MSE):
        raise ValueError(
            "per-level halo exchange implements the blind-spot forward; "
            f"pipeline {cfg.pipeline} has no rotated branches — use the "
            "clamped-window modes"
        )
    if cfg.model.conv_backend != "lax" or cfg.model.head_backend != "lax":
        raise ValueError("per-level mode supports the lax backends only")
    n = group.world
    compute_dtype = getattr(torch, cfg.model.compute_dtype)
    precision = cfg.model.conv_precision

    @torch.inference_mode()
    def strip_fn(params, strip, noise_vec):
        x = strip.permute(0, 3, 1, 2).to(compute_dtype)
        rev = ppermute(x, _rev(n), group)
        # branch strips, rank-local: W-mode pair (rot0, rot180), H-mode
        # pair (rot90, rot270)
        aw = torch.cat([x, rot90(rev, 2)], dim=0)
        ah = torch.cat([rot90(rev, 1), rot90(x, 3)], dim=0)
        fw = _branch_w(params, aw, group, precision)
        fh = _branch_h(params, ah, group, precision)
        # +1 px blind-spot shift in each branch's own frame
        fw = F.pad(fw, (0, 0, 1, -1))
        fh = _shift_down_h(fh, group)
        b = strip.shape[0]
        parts = [
            fw[:b],
            ppermute(rot90(fh[:b], -1), _rev(n), group),
            ppermute(rot90(fw[b:], 2), _rev(n), group),
            rot90(fh[b:], -3),
        ]
        f = torch.cat(parts, dim=1).to(compute_dtype)
        # 1x1 head, pixel-local (as models.blindspot_unet.apply)
        f = leaky_relu(_conv(f, params["nin_a"]["w"], params["nin_a"]["b"],
                             (0, 0), (0, 0), precision))
        f = leaky_relu(_conv(f, params["nin_b"]["w"], params["nin_b"]["b"],
                             (0, 0), (0, 0), precision))
        p = params["nin_c"]
        out = matmul_acc_f32(f.permute(0, 2, 3, 1), p["w"][:, :, 0, 0].t())
        out = out + p["b"].float()
        c = strip.shape[-1]
        if cfg.pipeline != Pipeline.SSDN:
            return estimator.mu_only(out, c)
        if cfg.noise.value == NoiseValue.BLIND:
            noise_cfg, noise_params = _blind_eval_cfg(cfg.noise, out, c,
                                                      group)
        else:
            noise_cfg = cfg.noise
            noise_params = runtime_noise_params(cfg.noise, params, noise_vec)
        return estimator.posterior_mean(out, strip.float(), noise_cfg,
                                        noise_params,
                                        bound=cfg.bound_outputs)

    return strip_fn


def tiled_denoise_perlevel(
    cfg: TrainConfig,
    params,
    noisy: np.ndarray,
    noise_param,
    group: Group,
) -> np.ndarray:
    """Denoise one (H, W, C) image with per-level halo exchange over
    ``group``; every rank passes the same image and returns the whole
    denoised (H, W, C) numpy image.

    W pads (reflect) to a multiple of STRIDE * n so strips split evenly.
    The output equals the untiled forward exactly when that equals the
    untiled STRIDE-multiple padding, and differs only in right-edge
    context (both valid denoisings) when the image is narrower than
    STRIDE * n forces extra pad.
    """
    n = group.world
    padded, (h, w) = pad_to_multiple(noisy, STRIDE, multiple_w=STRIDE * n)
    ws = padded.shape[1] // n
    strip = torch.as_tensor(
        padded[None, :, group.rank * ws:(group.rank + 1) * ws],
        device=group.device)
    noise_vec = torch.as_tensor(noise_param, dtype=torch.float32,
                                device=group.device)
    out = make_per_level_fn(cfg, group)(params, strip, noise_vec)
    return all_gather_w(out, group)[0, :h, :w].cpu().numpy()
