"""NLL losses and Bayesian posterior-mean estimators (SURVEY.md §2.5): a
port of ``ssdn_tpu/estimator/core.py`` in PyTorch.

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
the same units (sigma_255 / 255). The training losses are ``nll`` (the
stabilized objective: Huberized whitened residuals, tanh soft bounds,
beta-NLL weights; or the reference's raw NLL) and ``mse_loss``.
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
# Huber threshold on the whitened residual of the robust NLL (the JAX
# module explains the runaway it caps).
_HUBER_DELTA = 5.0
# Soft output bounds (x -> L tanh(x/L)) of the stabilized objective.
_MU_BOUND = 2.0
_A_BOUND = 4.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) with no threshold cut-off (jax.nn.softplus's form)
    return torch.logaddexp(x, torch.zeros_like(x))


def _huber_quad(z: torch.Tensor, delta: float = _HUBER_DELTA) -> torch.Tensor:
    """x^2-like penalty with linear tails: z^2 for |z| <= delta, else
    2 delta |z| - delta^2 (continuous, with a continuous gradient)."""
    az = torch.abs(z)
    return torch.where(az <= delta, z * z, 2.0 * delta * az - delta * delta)


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


def _gauss_nll_post_1(mu, a, y, var, robust=False):
    """C=1 closed forms; all (B,H,W,1). Returns (nll, posterior, per-pixel
    variance scale for the beta-NLL weight)."""
    sigma_x = a[..., :1] ** 2
    var_y = sigma_x + var + _VAR_EPS
    d = y - mu
    z2 = d * d / var_y
    if robust:
        z2 = _huber_quad(d * torch.rsqrt(var_y))
    nll = 0.5 * (z2 + torch.log(var_y) + _LOG2PI)
    post = mu + sigma_x / var_y * d
    return nll[..., 0], post, var_y[..., 0]


def _gauss_nll_post_3(mu, a, y, var, robust=False):
    """C=3 via the closed-form SPD3 path; robust=True Huberizes each
    whitened residual component z = L^{-1} d. Returns (nll, posterior,
    per-pixel variance scale for the beta-NLL weight)."""
    sx = spd3.sym3_from_tri(a)
    sy = spd3.sym3_add_diag(sx, tuple(var[..., i] for i in range(3)))
    d = tuple(y[..., i] - mu[..., i] for i in range(3))
    L = spd3.chol3(sy)
    z = spd3.chol3_forward_sub(L, d)
    if robust:
        quad = _huber_quad(z[0]) + _huber_quad(z[1]) + _huber_quad(z[2])
    else:
        quad = z[0] * z[0] + z[1] * z[1] + z[2] * z[2]
    logdet = spd3.chol3_logdet(L)
    nll = 0.5 * (quad + logdet + 3.0 * _LOG2PI)
    w = spd3.chol3_back_sub(L, z)
    post = spd3.sym3_matvec(sx, w)
    post = torch.stack([mu[..., i] + post[i] for i in range(3)], dim=-1)
    # geometric-mean per-channel variance = exp(logdet / 3)
    return nll, post, torch.exp(logdet / 3.0)


def _gauss_nll_post(mu, a, y, var, robust=False):
    c = mu.shape[-1]
    if c == 1:
        return _gauss_nll_post_1(mu, a, y, var, robust)
    if c == 3:
        return _gauss_nll_post_3(mu, a, y, var, robust)
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


def nll(out: torch.Tensor, y: torch.Tensor, cfg: NoiseConfig,
        noise_params: Dict, *, blind_reg=0.1, beta: float = 1.0,
        robust: bool = True, bound: bool = True, batch_mean=torch.mean):
    """Mean negative log-likelihood training loss. Returns (scalar, aux).

    beta is the beta-NLL pixel-weight exponent: each pixel's NLL is scaled
    by var_scale.detach() ** beta, normalised by its batch mean (per-pixel
    optima unchanged; beta=0 is the raw NLL). robust=True Huberizes the
    whitened residuals; robust=False, bound=False, beta=0 is the reference
    repo's raw NLL. Blind models subtract blind_reg times the estimated
    noise scale (Gaussian, Poisson) or add a log-barrier on alpha
    (impulse). aux holds sigma / sigma_hat / lam_hat / alpha_hat as the
    noise model gives them, and mu_mse.

    batch_mean(t) is the mean of the detached beta weights over the whole
    batch: ``torch.mean`` on one device; under data parallelism each rank
    holds some rows, and the training step passes the mean over every
    rank's rows (the one term of the loss that does not split by rows).
    """
    out = out.float()
    y = y.float()
    c = y.shape[-1]
    # BLIND uses an extra network channel; BLIND_CONST estimates too, but
    # through the learned free scalar (noise_params["raw_scale"])
    blind = cfg.value == NoiseValue.BLIND
    blind_est = cfg.value in (NoiseValue.BLIND, NoiseValue.BLIND_CONST)
    mu, a, noise_ch = split_outputs(out, c, blind, bound=bound)
    aux = {}
    if cfg.model in (NoiseModel.GAUSSIAN, NoiseModel.POISSON):
        var, scale = _noise_variance(cfg, noise_params, mu, noise_ch)
        pix_nll, _, var_scale = _gauss_nll_post(mu, a, y, var, robust=robust)
        if beta:
            w = var_scale.detach() ** beta
            pix_nll = w / batch_mean(w) * pix_nll
        loss = torch.mean(pix_nll)
        if blind_est:
            # anti-degeneracy regularizer, the same form for both models
            loss = loss - blind_reg * torch.mean(scale)
            if cfg.model == NoiseModel.GAUSSIAN:
                aux["sigma_hat"] = scale
            else:
                aux["lam_hat"] = 0.5 / (scale ** 2 + 1e-8)
        elif scale is not None:
            aux["sigma"] = scale
    elif cfg.model == NoiseModel.IMPULSE:
        alpha = _impulse_alpha(cfg, noise_params, noise_ch, out.device)
        log_n = _prior_logdensity(mu, a, y)  # (B,H,W)
        # p(y) = alpha * 1 + (1-alpha) * N, in log space
        log_p = torch.logaddexp(
            torch.log(alpha + 1e-12) + torch.zeros_like(log_n),
            torch.log1p(-alpha + 1e-12) + log_n,
        )
        loss = torch.mean(-log_p)
        if blind_est:
            # symmetric log-barrier on alpha_hat (the impulse analogue of
            # the blind-sigma regularizer)
            loss = loss + blind_reg * torch.mean(
                -torch.log(alpha) - torch.log1p(-alpha))
            aux["alpha_hat"] = alpha[..., 0, 0] if alpha.dim() else alpha
    else:
        raise ValueError(cfg.model)
    aux["mu_mse"] = torch.mean((mu - y) ** 2)
    return loss, aux


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
        _, post, _ = _gauss_nll_post(mu, a, y, var)
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


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - target.float()) ** 2)
