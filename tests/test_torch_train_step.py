"""The port's training step (``ssdn_tpu_torch.train``) against the JAX
package's, on the CPU at narrow widths (enc 16, dec 32, nin 64/32), 32x32
patches, batch 2, fp32.

Both sides start from the same params (the JAX ``init_state`` tree, carried
over by ``params_from_jax``) and see the same numpy-made noisy batch: the
JAX loss is written here from the JAX package's public functions, line for
line as ``ssdn_tpu/train/step.py``'s ``loss_fn``, and differentiated by
``jax.value_and_grad``; the port's is ``TrainStep.loss_and_grads``. Bars:
the loss at 1e-5 relative; each leaf's gradient at 1e-4 of that leaf's max
abs (17 convs and the head in fp32, summation order only). This file runs
the torch-ops arm; ``test_torch_train_step_kernels.py`` the kernel arms.
Also here: the schedules, Adam with and without the clip against optax, a
10-step trajectory, determinism and every pipeline stepping.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ssdn_tpu.config as jcfg
import ssdn_tpu.ops.pallas.nin_head as NH
import ssdn_tpu_torch.config as tcfg
from ssdn_tpu import estimator as jest
from ssdn_tpu.models import blindspot_unet as jbu
from ssdn_tpu.train import step as jstep
from ssdn_tpu_torch.models.blindspot_unet import params_from_jax, params_to_jax
from ssdn_tpu_torch.train import step as tstep

# name: (pipeline, noise style, blind mode, grayscale)
PIPELINES = {
    "ssdn_gauss25_rgb": ("ssdn", "gauss25", False, False),
    "ssdn_gauss25_gray": ("ssdn", "gauss25", False, True),
    "ssdn_blind_rgb": ("ssdn", "gauss5_50", True, False),
    "ssdn_blind_const_rgb": ("ssdn", "gauss25", "const", False),
    "ssdn_mse_gray": ("ssdn_mse", "gauss25", False, True),
    "n2c_rgb": ("n2c", "gauss25", False, False),
    "n2n_gray": ("n2n", "gauss25", False, True),
}
ARMS = {"lax": ("lax", "lax"), "head_pallas": ("lax", "pallas"),
        "conv_pallas": ("pallas", "lax")}


@pytest.fixture(autouse=True)
def _nh_interpret():
    NH.INTERPRET = True
    yield
    NH.INTERPRET = False


def tiny_cfg(mod, name, arm="lax", **over):
    pipeline, style, blind, gray = PIPELINES[name]
    conv, head = ARMS[arm]
    kw = dict(patch_size=32, batch_size=2, iterations=60, lr=1e-3, seed=0,
              grayscale=gray)
    kw.update(over)
    return mod.TrainConfig(
        pipeline=mod.Pipeline(pipeline),
        noise=mod.parse_noise_style(style, blind=blind),
        model=mod.ModelConfig(
            in_channels=1 if gray else 3, compute_dtype="float32",
            enc_features=16, dec_features=32, nin_a_features=64,
            nin_b_features=32, conv_backend=conv, head_backend=head),
        **kw)


def numpy_batch(cfg, seed):
    """(x, y, noise_params, y2): a clean batch, a Gaussian-noisy copy at the
    config's sigma (one draw per image from its range), and an independent
    second copy (N2N's target)."""
    rng = np.random.default_rng(seed)
    c = cfg.model.in_channels
    x = rng.uniform(-0.5, 0.5, (2, 32, 32, c)).astype(np.float32)
    sig = rng.uniform(cfg.noise.sigma_min, cfg.noise.sigma_max, 2)
    sig = (sig / 255).astype(np.float32)
    noisy = lambda: (x + sig[:, None, None, None]
                     * rng.standard_normal(x.shape)).astype(np.float32)
    return x, noisy(), {"sigma": sig}, noisy()


def jax_loss(cfg, params, x, y, noise_params, y2, step):
    """ssdn_tpu/train/step.py's loss_fn, on a given noisy batch."""
    out = jbu.apply(
        params, y, blindspot=jstep.pipeline_blindspot(cfg.pipeline),
        compute_dtype=jnp.dtype(cfg.model.compute_dtype),
        conv_backend=cfg.model.conv_backend,
        conv_precision=cfg.model.conv_precision,
        decoder_mode=cfg.model.decoder_mode,
        head_backend=cfg.model.head_backend)
    if cfg.pipeline == jcfg.Pipeline.SSDN:
        np_ = dict(noise_params)
        if "noise_scalar" in params:
            np_["raw_scale"] = params["noise_scalar"]["raw"]
        return jest.nll(out, y, cfg.noise, np_,
                        blind_reg=jstep.blind_reg_schedule(cfg)(step),
                        beta=cfg.nll_beta, robust=cfg.robust_nll,
                        bound=cfg.bound_outputs)
    if cfg.pipeline == jcfg.Pipeline.SSDN_MSE:
        return jest.mse_loss(jest.mu_only(out, x.shape[-1]), y), {}
    if cfg.pipeline == jcfg.Pipeline.N2C:
        return jest.mse_loss(out, x), {}
    return jest.mse_loss(out, y2), {}


def _jax_args(batch):
    x, y, npar, y2 = batch
    return (jnp.asarray(x), jnp.asarray(y),
            {k: jnp.asarray(v) for k, v in npar.items()}, jnp.asarray(y2))


def _torch_args(batch):
    x, y, npar, y2 = batch
    t = torch.from_numpy
    return t(x), t(y), {k: t(v) for k, v in npar.items()}, t(y2)


def assert_loss_and_grads_match(name, arm, seed=0):
    jc, tc = tiny_cfg(jcfg, name, arm), tiny_cfg(tcfg, name, arm)
    params = jstep.init_state(jc).params
    batch = numpy_batch(jc, seed)
    (lj, auxj), gj = jax.value_and_grad(
        lambda p: jax_loss(jc, p, *_jax_args(batch), 0), has_aux=True)(params)
    tree = jax.tree.map(np.asarray, params)
    ts = tstep.make_train_step(tc, device="cpu")
    lt, auxt, gt = ts.loss_and_grads(params_from_jax(tree, device="cpu"),
                                     *_torch_args(batch), 0)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    assert sorted(auxt) == sorted(auxj)
    gj, gt = jax.tree.map(np.asarray, gj), params_to_jax(gt)
    assert sorted(gt) == sorted(gj)
    for layer, leaf in gj.items():
        for key, ref in leaf.items():
            got = gt[layer][key]
            assert got.shape == ref.shape, (layer, key)
            np.testing.assert_allclose(
                got, ref, rtol=0, atol=1e-4 * max(np.abs(ref).max(), 1e-30),
                err_msg=f"{name}/{arm}: d loss / d {layer}.{key}")


@pytest.mark.parametrize("name", list(PIPELINES))
def test_loss_and_grads_match_jax_lax_arm(name):
    assert_loss_and_grads_match(name, "lax")


# ------------------------------ schedules ------------------------------


@pytest.mark.parametrize("over", [{}, dict(lr_rampdown_frac=0.0),
                                  dict(blind_reg_rampdown_frac=0.5),
                                  dict(lr_rampdown_frac=1.0,
                                       blind_reg_rampdown_frac=0.25)])
def test_schedules_match_jax(over):
    jc = tiny_cfg(jcfg, "ssdn_blind_rgb", iterations=100, **over)
    tc = tiny_cfg(tcfg, "ssdn_blind_rgb", iterations=100, **over)
    # JAX evaluates the cosine in fp32, the port in float64: the bar is
    # fp32 precision of the schedule's peak value
    for step in (0, 1, 30, 49, 50, 69, 70, 75, 85, 99, 100, 120):
        np.testing.assert_allclose(tstep.lr_schedule(tc)(step),
                                   float(jstep.lr_schedule(jc)(step)),
                                   rtol=1e-6, atol=1e-6 * tc.lr)
        np.testing.assert_allclose(tstep.blind_reg_schedule(tc)(step),
                                   float(jstep.blind_reg_schedule(jc)(step)),
                                   rtol=1e-6, atol=1e-6 * tc.blind_reg)


def test_init_state_matches_jax_layout():
    for name in ("ssdn_blind_const_rgb", "n2c_rgb", "ssdn_gauss25_gray"):
        jp = jax.tree.map(np.asarray, jstep.init_state(
            tiny_cfg(jcfg, name)).params)
        st = tstep.init_state(tiny_cfg(tcfg, name), device="cpu")
        got = params_to_jax(st.params)
        assert st.step == 0 and sorted(got) == sorted(jp)
        for layer, leaf in jp.items():
            for key, ref in leaf.items():
                assert got[layer][key].shape == ref.shape, (name, layer, key)
        if "noise_scalar" in jp:
            np.testing.assert_allclose(got["noise_scalar"]["raw"],
                                       jp["noise_scalar"]["raw"], rtol=1e-6)
        for tree in st.opt_state.values():
            assert all(float(t.abs().max()) == 0 for leaf in tree.values()
                       for t in leaf.values())


# ------------------------------ Adam ------------------------------


@pytest.mark.parametrize("clip", [0.0, 0.05, 1e3])
def test_adam_steps_match_optax(clip):
    """Two optimizer steps on the same grads (JAX's, at the shared params):
    the port's Adam (b2 0.99, eps outside the root, bias correction) and
    global-norm clip against optax's. clip 0.05 scales, 1e3 does not."""
    jc = tiny_cfg(jcfg, "ssdn_blind_const_rgb", grad_clip=clip)
    tc = tiny_cfg(tcfg, "ssdn_blind_const_rgb", grad_clip=clip)
    params = jstep.init_state(jc).params
    opt = jstep.make_optimizer(jc)
    ostate = opt.init(params)
    state = tstep.state_from_params(
        params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    ts = tstep.make_train_step(tc, device="cpu")
    for i in range(2):
        batch = numpy_batch(jc, 10 + i)
        _, g = jax.value_and_grad(
            lambda p: jax_loss(jc, p, *_jax_args(batch), i)[0])(params)
        if clip == 0.05:
            assert float(optax.global_norm(g)) > clip  # the clip engages
        updates, ostate = opt.update(g, ostate, params)
        params = optax.apply_updates(params, updates)
        state = ts.apply_grads(
            state, params_from_jax(jax.tree.map(np.asarray, g), device="cpu"))
    assert state.step == 2
    got = params_to_jax(state.params)
    for layer, leaf in jax.tree.map(np.asarray, params).items():
        for key, ref in leaf.items():
            np.testing.assert_allclose(got[layer][key], ref, rtol=1e-6,
                                       atol=1e-7, err_msg=f"{layer}.{key}")


def test_ten_step_trajectory_tracks_jax():
    """Ten matched-batch steps (SSDN, gauss25, RGB), at the bounds of
    tests/test_torch_full_model.py's matched Adam trajectory: the first
    loss at 1e-5, the losses at 5e-3, the final weights at 2e-2."""
    jc, tc = tiny_cfg(jcfg, "ssdn_gauss25_rgb"), tiny_cfg(tcfg, "ssdn_gauss25_rgb")
    st = jstep.init_state(jc)
    opt = jstep.make_optimizer(jc)

    @jax.jit
    def step(params, ostate, x, y, npar, y2, i):
        (loss, _), g = jax.value_and_grad(
            lambda p: jax_loss(jc, p, x, y, npar, y2, i), has_aux=True)(params)
        updates, ostate = opt.update(g, ostate, params)
        return optax.apply_updates(params, updates), ostate, loss

    params, ostate = st.params, st.opt_state
    state = tstep.state_from_params(
        params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    ts = tstep.make_train_step(tc, device="cpu")
    lj, lt = [], []
    for i in range(10):
        batch = numpy_batch(jc, 100 + i)
        params, ostate, loss = step(params, ostate, *_jax_args(batch), i)
        lj.append(float(loss))
        state, m = ts.step_on(state, *_torch_args(batch)[:3])
        lt.append(float(m["loss"]))
    np.testing.assert_allclose(lt[0], lj[0], rtol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=5e-3)
    got = params_to_jax(state.params)
    for layer, leaf in jax.tree.map(np.asarray, params).items():
        np.testing.assert_allclose(got[layer]["w"], leaf["w"], atol=2e-2,
                                   err_msg=f"weights diverged at {layer}")


# --------------------------- the whole step ---------------------------


def _u8_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    c = cfg.model.in_channels
    return rng.integers(0, 256, (2, 32, 32, c), dtype=np.uint8)


def _run(cfg, n, state=None):
    ts = tstep.make_train_step(cfg, device="cpu")
    state = state or tstep.init_state(cfg, device="cpu")
    losses = []
    for _ in range(n):
        state, m = ts(state, _u8_batch(cfg, state.step))
        losses.append(float(m["loss"]))
    return state, losses


def test_determinism_and_exact_resume():
    cfg = tiny_cfg(tcfg, "ssdn_gauss25_gray")
    s1, l1 = _run(cfg, 3)
    s2, l2 = _run(cfg, 3)
    assert l1 == l2
    # resume from the state after step 1: the step's generator is seeded
    # from (seed, step), so no RNG state needs saving
    mid, l_mid = _run(cfg, 1)
    s3, l_rest = _run(cfg, 2, state=mid)
    assert l_mid + l_rest == l1
    for a, b, c in zip(*(tstep._leaves(s.params) for s in (s1, s2, s3))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("pipeline,noise,blind,gray", [
    ("ssdn", "gauss25", False, True),
    ("ssdn", "gauss5_50", True, False),
    ("ssdn", "poisson30", False, False),
    ("ssdn", "impulse50", False, False),
    ("ssdn", "poisson5_50", True, False),
    ("ssdn", "impulse30_60", True, False),
    ("ssdn", "impulse50", "const", True),
    ("ssdn_mse", "gauss25", False, True),
    ("n2c", "gauss25", False, False),
    ("n2n", "gauss25", False, True),
])
def test_every_pipeline_steps(pipeline, noise, blind, gray):
    cfg = dataclasses.replace(
        tiny_cfg(tcfg, "ssdn_gauss25_rgb"), pipeline=tcfg.Pipeline(pipeline),
        noise=tcfg.parse_noise_style(noise, blind=blind), grayscale=gray)
    state, losses = _run(cfg, 2)
    assert np.isfinite(losses).all() and state.step == 2
    for t in tstep._leaves(state.params):
        assert torch.isfinite(t).all()
