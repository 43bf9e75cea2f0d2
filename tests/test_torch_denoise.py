"""The port's pretrained denoise path, end to end, against the JAX package.

Every bundled artifact is loaded by both packages' ``zoo.load`` and denoises
the same numpy-noisy image through both packages' ``make_denoise_fn`` and
``denoise_image`` — trained weights at full width (enc 48, dec 96, nin
384/96). With the compute dtype forced to float32 on both sides, the
posterior means agree to 1e-4 (rtol and atol): the two frameworks differ
only in fp32 summation order. Also here: the head kernel arm, one bf16
model as recorded, the zoo itself, and the port's CLI on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.ops.pallas.nin_head as NH
from ssdn_tpu import zoo as jzoo
from ssdn_tpu.config import to_json as jax_to_json
from ssdn_tpu.infer import full as jfull
from ssdn_tpu_torch import zoo as tzoo
from ssdn_tpu_torch.config import NoiseModel, to_json
from ssdn_tpu_torch.infer import full as tfull
from ssdn_tpu_torch.models.blindspot_unet import params_from_jax
from ssdn_tpu_torch.utils.images import psnr

ARTIFACTS = ["gauss25_gray", "gauss25_rgb", "gauss5_50_blind_rgb",
             "impulse30_60_blind_rgb", "impulse50_rgb", "poisson30_rgb",
             "poisson5_50_blind_rgb"]
NON_SQUARE = {"gauss25_gray", "impulse50_rgb"}  # the two-trunk fold
TOL = dict(rtol=1e-4, atol=1e-4)

# One intra-op torch thread in every test process. The suite runs files in
# parallel workers on a shared CPU, and each worker imports every test file
# while collecting, so this holds for all of them. torch's default of one
# thread per core oversubscribes the CPU and slows wall-clock comparisons
# in other workers (tests/test_native.py's throughput check lost 4 of 12
# races beside tests/test_torch_full_model.py at 8 threads, 0 of 24 at
# one). The torch tests take no longer with it.
torch.set_num_threads(1)


@pytest.fixture
def nh_interpret():
    NH.INTERPRET = True
    yield
    NH.INTERPRET = False


def _clean(h, w, c, seed):
    """A smooth field plus a few flat shapes, in the internal range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.3 * np.sin(xx / (7 + 3 * k) + yy / (11 + k))
                    for k in range(c)], -1)
    for _ in range(4):
        r, q = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[r:r + 8, q:q + 8] = rng.uniform(-0.4, 0.4, c)
    return np.clip(img, -0.5, 0.5).astype(np.float32)


def _noisy(cfg, clean, seed):
    """Noise at the artifact's own setting, made with numpy; returns the
    noisy image and the noise-parameter vector the estimator reads."""
    rng = np.random.default_rng(seed)
    n = cfg.noise
    if n.model == NoiseModel.GAUSSIAN:
        sigma = 0.5 * (n.sigma_min + n.sigma_max) / 255.0
        return clean + rng.normal(0, sigma, clean.shape).astype(np.float32), \
            np.full((1,), sigma, np.float32)
    if n.model == NoiseModel.POISSON:
        lam = n.lam if n.lam_max is None else 0.5 * (n.lam + n.lam_max)
        y = rng.poisson(lam * (clean + 0.5)) / lam - 0.5
        return y.astype(np.float32), np.full((1,), lam, np.float32)
    alpha = n.alpha if n.alpha_max is None else 0.5 * (n.alpha + n.alpha_max)
    hit = rng.random(clean.shape[:2] + (1,)) < alpha
    y = np.where(hit, rng.uniform(-0.5, 0.5, clean.shape), clean)
    return y.astype(np.float32), np.full((1,), alpha, np.float32)


def _both(name, shape, seed, **model_overrides):
    """(port posterior mean, JAX posterior mean, clean, noisy)."""
    jcfg, jtree, _ = jzoo.load(name)
    tcfg, ttree, _ = tzoo.load(name)
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, **model_overrides))
    tcfg = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, **model_overrides))
    c = tcfg.model.in_channels
    clean = _clean(*shape, c, seed)
    noisy, pvec = _noisy(tcfg, clean, seed + 1)
    ref = jfull.denoise_image(jfull.make_denoise_fn(jcfg), jtree, noisy,
                              jnp.asarray(pvec))
    got = tfull.denoise_image(tfull.make_denoise_fn(tcfg, device="cpu"),
                              params_from_jax(ttree, device="cpu"), noisy,
                              pvec)
    return got, np.asarray(ref), clean, noisy


@pytest.mark.parametrize("name", ARTIFACTS)
def test_artifact_denoise_matches_jax_fp32(name):
    shape = (32, 64) if name in NON_SQUARE else (64, 64)
    got, ref, clean, noisy = _both(name, shape, ARTIFACTS.index(name),
                                   compute_dtype="float32")
    assert got.shape == clean.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)
    assert psnr(got, clean) > psnr(noisy, clean)


def test_flagship_head_kernel_arm_matches_jax(nh_interpret):
    got, ref, clean, noisy = _both("gauss25_rgb", (64, 64), 20,
                                   head_backend="pallas")
    np.testing.assert_allclose(got, ref, **TOL)
    assert psnr(got, clean) > psnr(noisy, clean) + 3.0


def test_flagship_conv_kernel_arm_matches_lax_arm():
    """The conv-kernel arm (K1's twin on the CPU, explicit final shift)
    against the port's own lax arm at the flagship's recorded fp32."""
    cfg, tree, _ = tzoo.load("gauss25_rgb")
    params = params_from_jax(tree, device="cpu")
    clean = _clean(64, 64, 3, 21)
    noisy, pvec = _noisy(cfg, clean, 22)
    outs = {}
    for conv in ("lax", "pallas"):
        c = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, conv_backend=conv))
        outs[conv] = tfull.denoise_image(
            tfull.make_denoise_fn(c, device="cpu"), params, noisy, pvec)
    np.testing.assert_allclose(outs["pallas"], outs["lax"], **TOL)


def test_bf16_artifact_close_to_jax():
    """poisson30_rgb as recorded (bf16 trunk). The frameworks round at the
    same points but sum in another order; one-ulp bf16 differences (2**-8)
    compound through 17 layers. Bar: 2/255 absolute on the posterior mean,
    and the port still denoises."""
    got, ref, clean, noisy = _both("poisson30_rgb", (64, 64), 30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 / 255)
    assert psnr(got, clean) > psnr(noisy, clean) + 3.0


def test_zoo_reads_the_same_artifacts():
    assert tzoo.available() == jzoo.available()
    assert set(ARTIFACTS) <= set(tzoo.available())
    for name in ("gauss25_rgb", "poisson5_50_blind_rgb"):
        tcfg, ttree, tmeta = tzoo.load(name)
        jcfg, jtree, jmeta = jzoo.load(name)
        assert to_json(tcfg) == jax_to_json(jcfg) and tmeta == jmeta
        assert sorted(ttree) == sorted(jtree)
        for layer in jtree:
            for leaf in jtree[layer]:
                np.testing.assert_array_equal(ttree[layer][leaf],
                                              jtree[layer][leaf])
    with pytest.raises(FileNotFoundError, match="gauss25_rgb"):
        tzoo.load("no_such_model")


def test_make_denoise_fn_needs_a_gpu_unless_cpu():
    cfg, _, _ = tzoo.load("gauss25_rgb")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tfull.make_denoise_fn(cfg)


def test_cli_denoise_on_cpu(tmp_path):
    from ssdn_tpu_torch.cli.denoise import main
    from ssdn_tpu_torch.utils import load_image, save_image

    rng = np.random.default_rng(11)
    img = np.clip(rng.uniform(0.2, 0.8, (64, 64, 3))
                  + rng.normal(0, 25 / 255, (64, 64, 3)), 0, 1)
    inp = tmp_path / "in" / "shot.png"
    save_image(str(inp), (img * 255).round().astype(np.uint8))
    outdir = tmp_path / "out"
    main(["--device", "cpu", "--pretrained", "gauss25_rgb", "--input",
          str(inp), "--output", str(outdir), "--param", "25"])
    out = outdir / "shot_denoised.png"
    assert out.exists()
    assert load_image(str(out)).shape == (64, 64, 3)
    # --tiled sharded without a launcher runs a group of one (gloo on the
    # CPU): the untiled image, up to one PNG level (tests/test_torch_tiled.py
    # and test_torch_sharded.py hold the arrays to 1e-4)
    main(["--device", "cpu", "--pretrained", "gauss25_rgb", "--input",
          str(inp), "--output", str(tmp_path / "sharded"), "--param", "25",
          "--tiled", "sharded"])
    sharded = load_image(str(tmp_path / "sharded" / "shot_denoised.png"))
    assert np.abs(sharded.astype(int)
                  - load_image(str(out)).astype(int)).max() <= 1
    # --workdir is ported (tests/test_torch_train_cli.py); a directory that
    # holds no training run is refused
    with pytest.raises(FileNotFoundError):
        main(["--device", "cpu", "--workdir", str(tmp_path / "empty"),
              "--input", str(inp), "--output", str(outdir)])
