"""The port's sharded tiled inference (``ssdn_tpu_torch/infer/tiled.py::
tiled_denoise_sharded`` and ``infer/halo.py::tiled_denoise_perlevel``) over
4 and 2 gloo ranks on the CPU, against the JAX package's own sharded
functions on a mesh of as many virtual CPU devices.

Both sides get the same numpy image and weights (the JAX ``init_state``
tree, carried over by ``params_from_jax``). The shapes are
``tests/test_tiled.py``'s and ``tests/test_halo.py``'s, at 4 ranks:
per-level at width 384 (strip 96) and 128 (strip 32: the deepest level's
local H is 1, the 2-hop fetch), exchange at strip 672 with the exact halo
and with halo 96 (the approximate mode, the same approximation on both
sides), gather at strip 64, ragged widths; the blind sigma / Poisson /
impulse estimates (a pmean of strip means) and the MSE pipeline; "auto"
routing the kernel arms (their plain twins on the CPU) to the window
modes. fp32 throughout; the bar is 1e-4 as in those files, 1e-3 where
``tests/test_halo.py`` allows it (lam = 0.5/s^2 amplifies the pmean's
summation order).

Every case of one world size runs in ONE spawn (a module fixture keeps
each case's output of every rank), so the test count stays and the spawn
count does not; every rank must return the same image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from ssdn_tpu import parallel as jparallel
from ssdn_tpu.config import ModelConfig as JModelConfig
from ssdn_tpu.config import Pipeline as JPipeline
from ssdn_tpu.config import TrainConfig as JTrainConfig
from ssdn_tpu.config import parse_noise_style as jparse_noise_style
from ssdn_tpu.infer.tiled import tiled_denoise_sharded as jsharded
from ssdn_tpu.train.step import init_state as jinit_state
from ssdn_tpu_torch.config import ModelConfig, Pipeline, TrainConfig
from ssdn_tpu_torch.config import parse_noise_style
from ssdn_tpu_torch.infer.halo import perlevel_supported
from ssdn_tpu_torch.infer.tiled import choose_mode, tiled_denoise_sharded
from ssdn_tpu_torch.parallel import Group

TINY = dict(enc_features=8, dec_features=16, nin_a_features=32,
            nin_b_features=16, compute_dtype="float32")
HALO = 320
SIGMA = 25 / 255

# name: (noise style, blind, pipeline, (conv, head) arm, width, halo,
#        strategy, noise param, atol); the JAX side runs the lax arm's
#        "window" strategy for the kernel arms (its kernels are TPU kernels)
CASES4 = {
    "perlevel_strip96": ("gauss25", False, "ssdn", "lax", 384, HALO,
                         "perlevel", SIGMA, 1e-4),
    "perlevel_strip32_two_hop": ("gauss25", False, "ssdn", "lax", 128, HALO,
                                 "perlevel", SIGMA, 1e-4),
    "perlevel_ragged": ("gauss25", False, "ssdn", "lax", 500, HALO, "auto",
                        SIGMA, 1e-4),
    "exchange_exact": ("gauss25", False, "ssdn", "lax", 4 * 672, HALO,
                       "window", SIGMA, 1e-4),
    "exchange_halo96": ("gauss25", False, "ssdn", "lax", 4 * 672, 96,
                        "window", SIGMA, 1e-4),
    "gather_strip64": ("gauss25", False, "ssdn", "lax", 256, HALO, "window",
                       SIGMA, 1e-4),
    "window_ragged": ("gauss25", False, "ssdn", "lax", 1000, 96, "window",
                      SIGMA, 1e-4),
    "blind_sigma": ("gauss5_50", "variable", "ssdn", "lax", 512, HALO,
                    "perlevel", SIGMA, 1e-4),
    "blind_poisson": ("poisson5_50", "variable", "ssdn", "lax", 512, HALO,
                      "perlevel", 30.0, 1e-3),
    "blind_impulse": ("impulse50", "variable", "ssdn", "lax", 512, HALO,
                      "perlevel", 0.5, 1e-4),
    "blind_sigma_window": ("gauss5_50", "variable", "ssdn", "lax", 256, HALO,
                           "window", SIGMA, 1e-4),
    "mse_pipeline": ("gauss25", False, "ssdn_mse", "lax", 256, HALO,
                     "perlevel", SIGMA, 1e-4),
    "auto_head_kernel": ("gauss25", False, "ssdn", "head", 256, HALO,
                         "auto", SIGMA, 1e-4),
    "auto_conv_kernel": ("gauss25", False, "ssdn", "conv", 4 * 672, HALO,
                         "auto", SIGMA, 1e-4),
}
CASES2 = {
    "perlevel_strip64": ("gauss25", False, "ssdn", "lax", 128, HALO,
                         "perlevel", SIGMA, 1e-4),
    "exchange_exact": ("gauss25", False, "ssdn", "lax", 2 * 672, HALO,
                       "window", SIGMA, 1e-4),
    "gather_strip128": ("gauss25", False, "ssdn", "lax", 256, HALO,
                        "window", SIGMA, 1e-4),
}
ARMS = {"lax": ("lax", "lax"), "head": ("lax", "pallas"),
        "conv": ("pallas", "lax")}


def _configs(style, blind, pipeline, arm):
    conv, head = ARMS[arm]
    jcfg = JTrainConfig(pipeline=JPipeline(pipeline),
                        noise=jparse_noise_style(style, blind=blind),
                        model=JModelConfig(in_channels=3, **TINY))
    cfg = TrainConfig(pipeline=Pipeline(pipeline),
                      noise=parse_noise_style(style, blind=blind),
                      model=ModelConfig(in_channels=3, conv_backend=conv,
                                        head_backend=head, **TINY))
    return jcfg, cfg


def _problem(name, spec, seed):
    style, blind, pipeline, arm, w, halo, strategy, param, _ = spec
    jcfg, cfg = _configs(style, blind, pipeline, arm)
    tree = {k: {n: np.asarray(v) for n, v in leaf.items()}
            for k, leaf in jinit_state(jcfg).params.items()}
    rng = np.random.default_rng(seed)
    noisy = rng.uniform(-0.5, 0.5, (32, w, 3)).astype(np.float32)
    pvec = np.full((1,), param, np.float32)
    return jcfg, cfg, tree, noisy, pvec, halo, strategy


def _spawn(cases, world):
    problems = {name: _problem(name, spec, seed)
                for seed, (name, spec) in enumerate(cases.items())}
    outs = torch_dist.run(torch_dist.sharded, world, {
        name: (cfg, tree, noisy, pvec, halo, strategy)
        for name, (_, cfg, tree, noisy, pvec, halo, strategy)
        in problems.items()})
    return problems, outs


@pytest.fixture(scope="module")
def four():
    return _spawn(CASES4, 4)


@pytest.fixture(scope="module")
def two():
    return _spawn(CASES2, 2)


def _check(run, cases, world, name):
    problems, outs = run
    jcfg, _, tree, noisy, pvec, halo, strategy = problems[name]
    for r in range(1, world):
        np.testing.assert_array_equal(outs[r][name], outs[0][name],
                                      err_msg=f"rank {r}")
    if cases[name][3] != "lax":
        strategy = "window"  # the lax arm's window modes on the JAX side
    mesh = jparallel.make_mesh(jax.devices()[:world],
                               axis=jparallel.TILE_AXIS)
    theirs = jsharded(jcfg, tree, noisy, jnp.asarray(pvec), mesh, halo=halo,
                      strategy=strategy)
    assert outs[0][name].shape == noisy.shape
    np.testing.assert_allclose(outs[0][name], theirs, rtol=0,
                               atol=cases[name][-1])


@pytest.mark.parametrize("name", sorted(CASES4))
def test_four_ranks_match_the_jax_package(four, name):
    _check(four, CASES4, 4, name)


@pytest.mark.parametrize("name", sorted(CASES2))
def test_two_ranks_match_the_jax_package(two, name):
    _check(two, CASES2, 2, name)


def test_the_cases_reach_the_modes_they_name():
    """Each case exercises the path its name says (the dispatch is the
    JAX package's ``choose_mode`` and ``perlevel_supported``)."""
    for cases, world in ((CASES4, 4), (CASES2, 2)):
        for name, (style, blind, pipeline, arm, w, halo, strategy, _,
                   _) in cases.items():
            _, cfg = _configs(style, blind, pipeline, arm)
            width = -(-w // (32 * world)) * 32 * world
            perlevel = strategy != "window" and perlevel_supported(cfg)
            mode = ("perlevel" if perlevel
                    else choose_mode(halo, width // world, width))
            for word in ("perlevel", "exchange", "gather"):
                if word in name:
                    assert mode == word, (name, mode)
            if name.startswith("auto_"):
                assert mode != "perlevel", name


@pytest.mark.parametrize("arm", ["head", "conv"])
def test_perlevel_refuses_the_kernel_arms(arm):
    _, cfg = _configs("gauss25", False, "ssdn", arm)
    assert not perlevel_supported(cfg)
    group = Group(rank=0, world=1, device=torch.device("cpu"),
                  backend="gloo")
    with pytest.raises(ValueError, match="lax"):
        tiled_denoise_sharded(cfg, None, np.zeros((32, 64, 3), np.float32),
                              np.full((1,), SIGMA, np.float32), group,
                              strategy="perlevel")
    with pytest.raises(ValueError, match="multiple of 32"):
        tiled_denoise_sharded(cfg, None, np.zeros((32, 64, 3), np.float32),
                              np.full((1,), SIGMA, np.float32), group,
                              halo=100, strategy="window")
