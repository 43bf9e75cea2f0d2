"""The port's noise injectors (``ssdn_tpu_torch.noise.add_noise``), by their
moments, as ``tests/test_noise_and_metrics.py`` checks the JAX package's:
torch.Generator and jax.random draw different numbers from one seed, so
the two are compared by distribution, not value for value."""

import math

import numpy as np
import torch

from ssdn_tpu_torch.config import parse_noise_style
from ssdn_tpu_torch.noise import add_noise


def gen(seed):
    return torch.Generator().manual_seed(seed)


def flat_batch(value=0.2, shape=(4, 32, 32, 3)):
    return torch.full(shape, value)


def test_gaussian_fixed_sigma_moments():
    x = flat_batch()
    y, p = add_noise(gen(0), x, parse_noise_style("gauss25"))
    np.testing.assert_allclose(p["sigma"].numpy(), 25 / 255, rtol=1e-6)
    resid = (y - x).numpy()
    assert y.dtype == torch.float32 and y.shape == x.shape
    # unbiased: within 4 standard errors of 0
    assert abs(resid.mean()) < 4 * (25 / 255) / math.sqrt(resid.size)
    np.testing.assert_allclose(resid.std(), 25 / 255, rtol=0.02)


def test_gaussian_blind_sigma_range_and_variability():
    x = flat_batch(shape=(64, 16, 16, 3))
    y, p = add_noise(gen(1), x, parse_noise_style("gauss5_50", blind=True))
    sig = p["sigma"].numpy() * 255
    assert sig.shape == (64,)
    assert (sig >= 5).all() and (sig <= 50).all()
    assert sig.std() > 5  # varies per image
    emp = (y - x).numpy().std(axis=(1, 2, 3)) * 255
    np.testing.assert_allclose(emp, sig, rtol=0.15)


def test_poisson_moments():
    lam = 30.0
    x = flat_batch(0.2, (8, 64, 64, 1))  # intensity 0.7
    y, p = add_noise(gen(2), x, parse_noise_style("poisson30"))
    resid = (y - x).numpy()
    assert abs(resid.mean()) < 2e-3  # unbiased
    np.testing.assert_allclose(resid.var(), 0.7 / lam, rtol=0.05)
    np.testing.assert_allclose(p["lam"].numpy(), lam)


def test_poisson_lambda_range():
    x = flat_batch(0.2, (32, 32, 32, 1))
    y, p = add_noise(gen(5), x, parse_noise_style("poisson5_50"))
    lam = p["lam"].numpy()
    assert (lam >= 5).all() and (lam <= 50).all() and lam.std() > 5
    emp = (y - x).numpy().var(axis=(1, 2, 3))
    np.testing.assert_allclose(emp, 0.7 / lam, rtol=0.25)


def test_poisson_clips_negative_rates():
    x = torch.full((1, 8, 8, 1), -0.6)  # below the valid range
    y, _ = add_noise(gen(3), x, parse_noise_style("poisson30"))
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), -0.5)


def test_impulse_replacement_stats():
    x = flat_batch(0.4, (8, 64, 64, 3))
    y, p = add_noise(gen(4), x, parse_noise_style("impulse50"))
    changed = (y != 0.4).any(dim=-1).numpy()
    np.testing.assert_allclose(changed.mean(), 0.5, atol=0.02)
    vals = y.numpy()[changed]
    assert abs(vals.mean()) < 0.01
    np.testing.assert_allclose(vals.std(), math.sqrt(1 / 12), rtol=0.05)
    assert (y.numpy()[~changed] == 0.4).all()  # whole colors replaced
    np.testing.assert_allclose(p["alpha"].numpy(), 0.5)


def test_impulse_alpha_range():
    x = flat_batch(0.4, (32, 32, 32, 3))
    y, p = add_noise(gen(6), x, parse_noise_style("impulse30_60"))
    alpha = p["alpha"].numpy()
    assert (alpha >= 0.3).all() and (alpha <= 0.6).all()
    rate = (y != 0.4).any(dim=-1).float().mean(dim=(1, 2)).numpy()
    np.testing.assert_allclose(rate, alpha, atol=0.06)


def test_injection_is_deterministic_per_generator_seed():
    x = flat_batch()
    cfg = parse_noise_style("gauss25")
    y1, _ = add_noise(gen(7), x, cfg)
    y2, _ = add_noise(gen(7), x, cfg)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    y3, _ = add_noise(gen(8), x, cfg)
    assert (y3 != y1).any()
