"""The port's estimator (ssdn_tpu_torch.estimator) against the JAX
package's: split_outputs and posterior_mean for Gaussian, Poisson and
impulse noise x known, variable-blind and constant-blind, C = 1 and 3,
with the soft output bounds on and off.

Both sides read the same numpy network outputs and noisy images. The math
is elementwise fp32 on both sides (closed-form 3x3 Cholesky for RGB), so
the bar is 1e-5 (rtol and atol).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.config as jcfg
import ssdn_tpu.estimator as jest
import ssdn_tpu_torch.config as tcfg
import ssdn_tpu_torch.estimator as test_
from ssdn_tpu_torch.estimator import spd3 as tspd3

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, W = 2, 6, 5


def _noise(cfg_mod, model, value):
    return cfg_mod.NoiseConfig(model=cfg_mod.NoiseModel(model),
                               value=cfg_mod.NoiseValue(value))


def _noise_params(model, value, rng):
    """The estimator's runtime dict, as numpy: a (B,) per-image value for
    known models, a learned raw scalar for constant-blind ones."""
    if value == "blind_const":
        return {"raw_scale": np.float32(rng.normal(-1.0, 0.5)),
                "sigma": np.full((B,), 0.1, np.float32)}
    key, lo, hi = {"gaussian": ("sigma", 0.02, 0.2),
                   "poisson": ("lam", 5.0, 50.0),
                   "impulse": ("alpha", 0.2, 0.6)}[model]
    return {key: rng.uniform(lo, hi, (B,)).astype(np.float32)}


@pytest.mark.parametrize("bound", [True, False])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("value", ["known", "blind", "blind_const"])
@pytest.mark.parametrize("model", ["gaussian", "poisson", "impulse"])
def test_posterior_mean_matches_jax(model, value, c, bound):
    rng = np.random.default_rng(zlib.crc32(f"{model}{value}{c}{bound}".encode()))
    n_out = c + c * (c + 1) // 2 + (value == "blind")
    out = (rng.standard_normal((B, H, W, n_out)) * 0.4).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, (B, H, W, c)).astype(np.float32)
    npar = _noise_params(model, value, rng)
    ref = jest.posterior_mean(
        jnp.asarray(out), jnp.asarray(y), _noise(jcfg, model, value),
        {k: jnp.asarray(v) for k, v in npar.items()}, bound=bound)
    got = test_.posterior_mean(
        torch.from_numpy(out), torch.from_numpy(y),
        _noise(tcfg, model, value),
        {k: torch.as_tensor(v) for k, v in npar.items()}, bound=bound)
    assert got.dtype == torch.float32 and got.shape == (B, H, W, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("bound", [True, False])
@pytest.mark.parametrize("c,blind", [(1, False), (3, True)])
def test_split_outputs_and_sigma(c, blind, bound):
    rng = np.random.default_rng(c)
    n_out = c + c * (c + 1) // 2 + blind
    out = (rng.standard_normal((B, H, W, n_out)) * 3).astype(np.float32)
    ref = jest.split_outputs(jnp.asarray(out), c, blind, bound=bound)
    got = test_.split_outputs(torch.from_numpy(out), c, blind, bound=bound)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    if blind:
        np.testing.assert_allclose(
            test_.estimate_sigma(got[2]).numpy(),
            np.asarray(jest.estimate_sigma(ref[2])), **TOL)
    np.testing.assert_array_equal(test_.mu_only(torch.from_numpy(out), c),
                                  np.asarray(jest.mu_only(jnp.asarray(out), c)))


def test_scalar_noise_param_broadcasts():
    """A scalar sigma (the shared training value) gives the same posterior
    as the same value repeated per image."""
    rng = np.random.default_rng(11)
    out = torch.from_numpy((rng.standard_normal((B, H, W, 9)) * 0.4
                            ).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, H, W, 3))
                         .astype(np.float32))
    cfg = _noise(tcfg, "gaussian", "known")
    a = test_.posterior_mean(out, y, cfg, {"sigma": torch.tensor(0.1)})
    b = test_.posterior_mean(out, y, cfg, {"sigma": torch.full((B,), 0.1)})
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_spd3_solve_against_dense():
    """The closed-form per-pixel Cholesky path against torch.linalg on the
    assembled 3x3 matrices (float64 reference)."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.standard_normal((50, 6)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((50, 3)).astype(np.float32))
    s = tspd3.sym3_add_diag(tspd3.sym3_from_tri(a), (0.1, 0.1, 0.1))
    w, quad, logdet = tspd3.sym3_solve_quad_logdet(
        s, tuple(d[:, i] for i in range(3)))
    s11, s12, s13, s22, s23, s33 = (t.double() for t in s)
    dense = torch.stack([torch.stack([s11, s12, s13], -1),
                         torch.stack([s12, s22, s23], -1),
                         torch.stack([s13, s23, s33], -1)], -2)
    ref_w = torch.linalg.solve(dense, d.double())
    torch.testing.assert_close(torch.stack(w, -1).double(), ref_w,
                               rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(logdet.double(), torch.logdet(dense),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(quad.double(), (d.double() * ref_w).sum(-1),
                               rtol=1e-3, atol=1e-3)
