"""The port's training losses (``estimator.nll``, ``estimator.mse_loss``)
against the JAX package's, on the CPU: the value, its gradient with respect
to the network output (and, for constant-blind models, the learned
scalar), and the aux values, for Gaussian, Poisson and impulse noise x
known, variable-blind and constant-blind, C = 1 and 3, with the robust
Huber term, the soft output bounds and the beta-NLL weight on and off.

Both sides read the same numpy outputs, noisy images and noise
parameters. The math is elementwise fp32 on both sides, so the bar is
1e-5 (relative, and 1e-5 of each gradient's range).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.config as jcfg
import ssdn_tpu.estimator as jest
import ssdn_tpu_torch.config as tcfg
import ssdn_tpu_torch.estimator as test_

B, H, W = 2, 6, 5
TOL = dict(rtol=1e-5, atol=1e-5)
# (robust, bound, beta): the stabilized objective, the reference's raw
# NLL, and the mixed corners
OBJECTIVES = {"stabilized": (True, True, 1.0), "reference": (False, False, 0.0)}
MIXED = [(True, False, 0.0), (False, True, 1.0), (True, True, 0.5)]


def _noise(cfg_mod, model, value):
    return cfg_mod.NoiseConfig(model=cfg_mod.NoiseModel(model),
                               value=cfg_mod.NoiseValue(value))


def _case(model, value, c, seed):
    rng = np.random.default_rng(seed)
    t = c * (c + 1) // 2
    n_out = c + t + (value == "blind")
    out = (rng.standard_normal((B, H, W, n_out)) * 0.4).astype(np.float32)
    # covariance factors away from 0: a near-singular Sigma_x makes the
    # fp32 gradients too ill-conditioned to compare at 1e-5
    a = out[..., c:c + t]
    out[..., c:c + t] = np.sign(a) * (np.abs(a) + 0.2)
    if model != "impulse":
        # two pixels with a tiny Sigma_x all the same: whitened residuals
        # beyond the Huber threshold of 5 (the impulse density has no
        # Huber term)
        out[0, 0, :2, c:c + t] = 0.01
    y = rng.uniform(-0.5, 0.5, (B, H, W, c)).astype(np.float32)
    key, lo, hi = {"gaussian": ("sigma", 0.02, 0.2),
                   "poisson": ("lam", 5.0, 50.0),
                   "impulse": ("alpha", 0.2, 0.6)}[model]
    npar = {key: rng.uniform(lo, hi, (B,)).astype(np.float32)}
    raw = np.float32(rng.normal(-1.0, 0.5))
    return out, y, npar, raw


def _both(model, value, c, robust, bound, beta, seed):
    out, y, npar, raw = _case(model, value, c, seed)
    const = value == "blind_const"
    kw = dict(blind_reg=0.1, beta=beta, robust=robust, bound=bound)

    def jloss(o, r):
        p = {k: jnp.asarray(v) for k, v in npar.items()}
        if const:
            p["raw_scale"] = r
        return jest.nll(o, jnp.asarray(y), _noise(jcfg, model, value), p, **kw)

    (lj, auxj), (gj, grj) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(out), jnp.asarray(raw))
    ot = torch.from_numpy(out).requires_grad_()
    rt = torch.tensor(raw).requires_grad_()
    p = {k: torch.from_numpy(v) for k, v in npar.items()}
    if const:
        p["raw_scale"] = rt
    lt, auxt = test_.nll(ot, torch.from_numpy(y), _noise(tcfg, model, value),
                         p, **kw)
    lt.backward()
    assert lt.dtype == torch.float32 and lt.dim() == 0
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    gj = np.asarray(gj)
    np.testing.assert_allclose(ot.grad.numpy(), gj, rtol=1e-5,
                               atol=1e-5 * np.abs(gj).max())
    if const:
        np.testing.assert_allclose(rt.grad.item(), float(grj), rtol=1e-5,
                                   atol=1e-7)
    assert sorted(auxt) == sorted(auxj)
    for k in auxj:
        np.testing.assert_allclose(auxt[k].detach().numpy(),
                                   np.asarray(auxj[k]), **TOL)


@pytest.mark.parametrize("objective", list(OBJECTIVES))
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("value", ["known", "blind", "blind_const"])
@pytest.mark.parametrize("model", ["gaussian", "poisson", "impulse"])
def test_nll_matches_jax(model, value, c, objective):
    robust, bound, beta = OBJECTIVES[objective]
    _both(model, value, c, robust, bound, beta,
          zlib.crc32(f"{model}{value}{c}{objective}".encode()))


@pytest.mark.parametrize("robust,bound,beta", MIXED)
@pytest.mark.parametrize("model,value,c", [("gaussian", "known", 3),
                                           ("poisson", "blind", 1)])
def test_nll_mixed_objectives_match_jax(model, value, c, robust, bound, beta):
    _both(model, value, c, robust, bound, beta,
          zlib.crc32(f"{model}{value}{c}{robust}{bound}{beta}".encode()))


def test_mse_loss_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    target = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    lj, gj = jax.value_and_grad(jest.mse_loss)(jnp.asarray(pred),
                                                jnp.asarray(target))
    pt = torch.from_numpy(pred).requires_grad_()
    lt = test_.mse_loss(pt, torch.from_numpy(target).to(torch.bfloat16))
    lt.backward()
    # the target in bf16 on the port's side only: mse upcasts both
    lj2 = jest.mse_loss(jnp.asarray(pred),
                        jnp.asarray(target, jnp.bfloat16))
    np.testing.assert_allclose(lt.item(), float(lj2), **TOL)
    pt2 = torch.from_numpy(pred).requires_grad_()
    test_.mse_loss(pt2, torch.from_numpy(target)).backward()
    np.testing.assert_allclose(pt2.grad.numpy(), np.asarray(gj), **TOL)
    assert float(lj) > 0


def test_huber_quad_matches_jax():
    from ssdn_tpu.estimator.core import _huber_quad as jhuber
    from ssdn_tpu_torch.estimator.core import _huber_quad as thuber

    z = np.linspace(-12, 12, 97).astype(np.float32)
    np.testing.assert_allclose(thuber(torch.from_numpy(z)).numpy(),
                               np.asarray(jhuber(jnp.asarray(z))), **TOL)
