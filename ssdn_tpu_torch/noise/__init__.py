"""Synthetic noise injectors, in PyTorch (port of ``ssdn_tpu/noise``).

Every draw comes from an explicit ``torch.Generator`` on the batch's
device, so injection runs where the batch lives (inside the training step,
on the card). ``torch.Generator`` and ``jax.random`` give different
numbers from the same seed: the tests check the injectors by their
moments. Images use the internal range [-1/2, 1/2]; sigmas are in 0..255
units in the config and converted here.

Per model:
  * gaussian: y = x + sigma/255 * N(0, I); sigma per image ~ U[smin, smax]
    (fixed when smin == smax);
  * poisson(lam): y = Poisson(lam * (x + 1/2)) / lam - 1/2; lam per image
    ~ U[lam, lam_max] when a range is configured;
  * impulse(alpha): each pixel is replaced, with probability alpha, by a
    uniform random color in [-1/2, 1/2)^C (the whole color together);
    alpha per image ~ U[alpha, alpha_max] when a range is configured.

Each injector returns the per-image (B,) parameter vector in ``params``
(what the KNOWN-value estimator consumes).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ssdn_tpu_torch.config import NoiseConfig, NoiseModel


def _uniform(generator, n, lo, hi, device) -> torch.Tensor:
    u = torch.rand((n,), generator=generator, device=device)
    return lo + (hi - lo) * u


def add_noise(generator: torch.Generator, x: torch.Tensor, cfg: NoiseConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Inject noise into a clean batch (B, H, W, C) in [-1/2, 1/2]. Returns
    (noisy fp32, params); ``generator`` must live on x's device."""
    x = x.float()
    b, dev = x.shape[0], x.device
    if cfg.model == NoiseModel.GAUSSIAN:
        if cfg.fixed_sigma:
            sigma = torch.full((b,), cfg.sigma_min / 255.0, device=dev)
        else:
            sigma = _uniform(generator, b, cfg.sigma_min / 255.0,
                             cfg.sigma_max / 255.0, dev)
        noise = torch.randn(x.shape, generator=generator, device=dev)
        return x + sigma[:, None, None, None] * noise, {"sigma": sigma}
    if cfg.model == NoiseModel.POISSON:
        if cfg.fixed_lam:
            lam = torch.full((b,), float(cfg.lam), device=dev)
        else:
            lam = _uniform(generator, b, cfg.lam, cfg.lam_max, dev)
        lam4 = lam[:, None, None, None]
        rate = torch.clamp(lam4 * (x + 0.5), min=0.0)
        y = torch.poisson(rate, generator=generator) / lam4 - 0.5
        return y, {"lam": lam}
    if cfg.model == NoiseModel.IMPULSE:
        if cfg.fixed_alpha:
            alpha = torch.full((b,), float(cfg.alpha), device=dev)
        else:
            alpha = _uniform(generator, b, cfg.alpha, cfg.alpha_max, dev)
        # one Bernoulli per pixel: the whole color is replaced together
        u = torch.rand(x.shape[:3], generator=generator, device=dev)
        mask = (u < alpha[:, None, None])[..., None]
        color = torch.rand(x.shape, generator=generator, device=dev) - 0.5
        return torch.where(mask, color, x), {"alpha": alpha}
    raise ValueError(cfg.model)
