"""Bayesian posterior-mean estimators (SURVEY.md §2.5), the inference half
of ``ssdn_tpu/estimator/core.py`` in PyTorch.

The network predicts a per-pixel Gaussian prior over the clean signal:
mean mu (C channels) and covariance Sigma_x (= a^2 for C=1; = A^T A with A
upper-triangular from 6 channels for C=3), plus one extra channel when the
noise parameter is blind-estimated (NoiseValue.BLIND). Constant-blind
models (BLIND_CONST) read a learned free scalar instead, threaded in as
``noise_params["raw_scale"]``. Per noise model [P]:

  * Gaussian:  denoised = mu + Sigma_x Sigma_y^{-1} (y - mu),
        Sigma_y = Sigma_x + sigma^2 I;
  * Poisson:   the same with per-channel variance max(mu + 1/2, eps)/lam
        (blind: (mu + 1/2) * 2 s^2, s the estimated std at mid-intensity);
  * Impulse:   denoised = w y + (1-w) mu, w = (1-alpha) N(y; mu, Sigma_x +
        eps I) / p(y), the posterior probability the pixel is uncorrupted.

All math is fp32 and elementwise on NHWC tensors (the JAX package's
layout). Images use the internal range [-1/2, 1/2]; sigma values are in
the same units (sigma_255 / 255). The training losses (``nll``,
``mse_loss``) come with the training step.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ssdn_tpu_torch.config import NoiseConfig, NoiseModel, NoiseValue
from ssdn_tpu_torch.estimator import spd3

_LOG2PI = math.log(2.0 * math.pi)
_VAR_EPS = 1e-8      # variance floor for the C=1 path
_IMPULSE_EPS = 1e-4  # Sigma_x diagonal epsilon for the impulse density
# Blind-alpha bounds: a scaled sigmoid into [_ALPHA_LO, _ALPHA_HI] keeps
# the mixture density finite at any network output (see the JAX module).
_ALPHA_LO = 0.02
_ALPHA_HI = 0.98
# Soft output bounds (x -> L tanh(x/L)) of the stabilized objective.
_MU_BOUND = 2.0
_A_BOUND = 4.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) with no threshold cut-off (jax.nn.softplus's form)
    return torch.logaddexp(x, torch.zeros_like(x))


def _as_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _soft_bound(x: torch.Tensor, limit: float) -> torch.Tensor:
    return limit * torch.tanh(x / limit)


def split_outputs(out: torch.Tensor, channels: int, blind: bool,
                  bound: bool = True):
    """(B,H,W,n_out) -> (mu, a_tri, noise_ch|None): C mu channels,
    C(C+1)/2 covariance channels, then one optional noise-estimate channel.
    bound=True applies the stabilized objective's tanh soft bounds."""
    t = channels * (channels + 1) // 2
    mu = out[..., :channels]
    a = out[..., channels : channels + t]
    if bound:
        mu = _soft_bound(mu, _MU_BOUND)
        a = _soft_bound(a, _A_BOUND)
    noise_ch = out[..., channels + t] if blind else None
    return mu, a, noise_ch


def estimate_sigma(noise_ch: torch.Tensor) -> torch.Tensor:
    """Per-image scalar sigma from the per-pixel map: spatial softplus-mean
    ([P] §3.1)."""
    return torch.mean(_softplus(noise_ch), dim=(1, 2))


def _const_scale(noise_params: Dict, batch: int, device) -> torch.Tensor:
    """BLIND_CONST noise scale (B,): softplus of the learned free scalar."""
    raw = _as_f32(noise_params["raw_scale"], device)
    return _softplus(raw).reshape(1).expand(batch)


def _noise_variance(cfg: NoiseConfig, noise_params: Dict, mu: torch.Tensor,
                    noise_ch):
    """Per-pixel-per-channel noise variance (B,H,W,C), plus the per-image
    noise-scale estimate (B,) (None when the parameter is known), for the
    Gaussian-family models."""
    b = mu.shape[0]
    if cfg.model == NoiseModel.GAUSSIAN:
        if cfg.value == NoiseValue.BLIND:
            sigma = estimate_sigma(noise_ch)
        elif cfg.value == NoiseValue.BLIND_CONST:
            sigma = _const_scale(noise_params, b, mu.device)
        else:
            # scalar (shared value) or (B,) (one value per image)
            sigma = _as_f32(noise_params["sigma"], mu.device)
            if sigma.dim() == 0:
                sigma = sigma.reshape(1).expand(b)
        var = (sigma ** 2)[:, None, None, None]
        return var.expand(mu.shape).float(), sigma
    if cfg.model == NoiseModel.POISSON:
        if cfg.value in (NoiseValue.BLIND, NoiseValue.BLIND_CONST):
            # s = the noise std at mid-intensity (s^2 = 0.5/lam), from the
            # network's extra channel (BLIND) or the free scalar (CONST)
            s = (estimate_sigma(noise_ch) if cfg.value == NoiseValue.BLIND
                 else _const_scale(noise_params, b, mu.device))
            var = torch.clamp(mu + 0.5, min=1e-3) * (
                2.0 * (s ** 2)[:, None, None, None]
            )
            return var.float(), s
        lam = _as_f32(noise_params["lam"], mu.device)
        if lam.dim() == 1:
            lam = lam[:, None, None, None]
        var = torch.clamp(mu + 0.5, min=1e-3) / lam
        return var.float(), None
    raise ValueError(f"no Gaussian-family variance for {cfg.model}")


def _gauss_nll_post_1(mu, a, y, var):
    """C=1 closed forms; all (B,H,W,1). Returns (nll, posterior)."""
    sigma_x = a[..., :1] ** 2
    var_y = sigma_x + var + _VAR_EPS
    d = y - mu
    nll = 0.5 * (d * d / var_y + torch.log(var_y) + _LOG2PI)
    post = mu + sigma_x / var_y * d
    return nll[..., 0], post


def _gauss_nll_post_3(mu, a, y, var):
    """C=3 via the closed-form SPD3 path. Returns (nll, posterior)."""
    sx = spd3.sym3_from_tri(a)
    sy = spd3.sym3_add_diag(sx, tuple(var[..., i] for i in range(3)))
    d = tuple(y[..., i] - mu[..., i] for i in range(3))
    L = spd3.chol3(sy)
    z = spd3.chol3_forward_sub(L, d)
    quad = z[0] * z[0] + z[1] * z[1] + z[2] * z[2]
    nll = 0.5 * (quad + spd3.chol3_logdet(L) + 3.0 * _LOG2PI)
    w = spd3.chol3_back_sub(L, z)
    post = spd3.sym3_matvec(sx, w)
    post = torch.stack([mu[..., i] + post[i] for i in range(3)], dim=-1)
    return nll, post


def _gauss_nll_post(mu, a, y, var):
    c = mu.shape[-1]
    if c == 1:
        return _gauss_nll_post_1(mu, a, y, var)
    if c == 3:
        return _gauss_nll_post_3(mu, a, y, var)
    raise ValueError(f"unsupported channel count {c}")


def _prior_logdensity(mu, a, y):
    """log N(y; mu, Sigma_x + eps I) — the clean-signal prior evaluated at y
    (impulse model's uncorrupted branch)."""
    c = mu.shape[-1]
    if c == 1:
        var = a[..., :1] ** 2 + _IMPULSE_EPS
        d = y - mu
        return (-0.5 * (d * d / var + torch.log(var) + _LOG2PI))[..., 0]
    sx = spd3.sym3_from_tri(a)
    sx = spd3.sym3_add_diag(sx, (_IMPULSE_EPS,) * 3)
    d = tuple(y[..., i] - mu[..., i] for i in range(3))
    _, quad, logdet = spd3.sym3_solve_quad_logdet(sx, d)
    return -0.5 * (quad + logdet + 3.0 * _LOG2PI)


def _impulse_alpha(cfg: NoiseConfig, noise_params: Dict, noise_ch, device):
    if cfg.value == NoiseValue.BLIND:
        # per-image scalar: spatial sigmoid-mean, scaled into the bounds
        s = torch.mean(torch.sigmoid(noise_ch), dim=(1, 2))
        return (_ALPHA_LO + (_ALPHA_HI - _ALPHA_LO) * s)[:, None, None]
    if cfg.value == NoiseValue.BLIND_CONST:
        raw = _as_f32(noise_params["raw_scale"], device)
        return _ALPHA_LO + (_ALPHA_HI - _ALPHA_LO) * torch.sigmoid(raw)
    alpha = _as_f32(noise_params["alpha"], device)
    return alpha.reshape((-1, 1, 1)) if alpha.dim() else alpha


def posterior_mean(out: torch.Tensor, y: torch.Tensor, cfg: NoiseConfig,
                   noise_params: Dict, *, bound: bool = True) -> torch.Tensor:
    """Bayes-denoised image E[x | y] (B,H,W,C), fp32. bound must match the
    objective the model was trained with (TrainConfig.bound_outputs)."""
    out = out.float()
    y = y.float()
    c = y.shape[-1]
    blind = cfg.value == NoiseValue.BLIND  # extra channel only for BLIND
    mu, a, noise_ch = split_outputs(out, c, blind, bound=bound)
    if cfg.model in (NoiseModel.GAUSSIAN, NoiseModel.POISSON):
        var, _ = _noise_variance(cfg, noise_params, mu, noise_ch)
        _, post = _gauss_nll_post(mu, a, y, var)
        return post
    if cfg.model == NoiseModel.IMPULSE:
        alpha = _impulse_alpha(cfg, noise_params, noise_ch, out.device)
        log_n = _prior_logdensity(mu, a, y)
        log_unc = torch.log1p(-alpha + 1e-12) + log_n
        log_p = torch.logaddexp(torch.log(alpha + 1e-12)
                                + torch.zeros_like(log_n), log_unc)
        w = torch.exp(log_unc - log_p)[..., None]  # P(uncorrupted | y)
        return w * y + (1.0 - w) * mu
    raise ValueError(cfg.model)


def mu_only(out: torch.Tensor, channels: int) -> torch.Tensor:
    """The network's mu — the SSDN_MSE ablation and N2C/N2N baselines."""
    return out[..., :channels].float()
