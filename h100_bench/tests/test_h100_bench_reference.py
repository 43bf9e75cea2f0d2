"""The plain reference (``h100_bench/reference/model.py``) held against the
port, ``ssdn_tpu_torch``, on the CPU at a small size with seeded weights.
Each test also runs once with a planted fault in the reference and must
then see the gap it checks open up, so no test passes by comparing
nothing."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from h100_bench import corpus
from h100_bench.reference import model as ref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = (False, True)


def fields(name: str, **over):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        d = json.load(f)["train_config"]
    d = copy.deepcopy(d)
    d.update(over)
    return d


def port_cfg(d):
    from ssdn_tpu_torch.config import train_config_from_json

    return train_config_from_json(json.dumps(d))


def fp32(d):
    d = copy.deepcopy(d)
    d["model"]["compute_dtype"] = "float32"
    d["model"]["head_backend"] = "lax"
    return d


def port_params(d, seed=3):
    from ssdn_tpu_torch.train.step import init_state

    st = init_state(port_cfg(dict(d, seed=seed)), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for leaf in st.params.values():  # non-zero biases
        leaf["b"] = 0.05 * torch.randn(leaf["b"].shape, generator=g)
    return st.params


def _gap(a, b):
    return float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_network_matches_port(monkeypatch, fault, hw):
    """The rotated blind-spot U-Net and its head, fp32, square and not."""
    from ssdn_tpu_torch.models import blindspot_unet

    d = fp32(fields("blind_bf16"))
    params = port_params(d)
    y = torch.rand((2, *hw, 3), generator=torch.Generator().manual_seed(5)) - .5
    want = blindspot_unet.apply(params, y, compute_dtype=torch.float32)
    if fault:  # no blind-spot shift
        monkeypatch.setattr(ref.F, "pad", _no_row_shift(ref.F.pad))
    with ref.Precision("fp32") as p:
        got = ref.network(p, params, y)
    assert (_gap(got, want) > 1e-3) == fault, _gap(got, want)


def _no_row_shift(pad):
    def patched(x, pads, *a, **k):
        if tuple(pads) == (0, 0, 1, 0) and not a and not k:
            return torch.cat([x, x[:, :, -1:]], dim=2)
        return pad(x, pads, *a, **k)
    return patched


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["blind_bf16", "ref_fp32"])
def test_posterior_matches_port(monkeypatch, fault, name):
    """The posterior mean of a whole image, padded, blind and known."""
    from ssdn_tpu_torch.infer.full import denoise_image, make_denoise_fn

    d = fp32(fields(name))
    params = port_params(d)
    noisy, sigma = corpus.photos(7, [(40, 70)], [30.0], "cpu")[0]
    want = denoise_image(make_denoise_fn(port_cfg(d), device="cpu"), params,
                         noisy, np.full((1,), sigma, np.float32))
    if fault:  # the noise variance left out of Sigma_y
        real = ref._gaussian_parts
        monkeypatch.setattr(ref, "_gaussian_parts",
                            lambda out, y, nz, s, st: real(out, y, nz, s * 0.5,
                                                           st)
                            if nz["value"] != "blind" else
                            real(out, y, {"value": "known"},
                                 torch.zeros(y.shape[0]), st))
    got = ref.denoise(d, params, noisy, sigma, "cpu")
    assert (_gap(got, want) > 1e-4) == fault, _gap(got, want)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["blind_bf16", "ref_fp32"])
def test_loss_and_grads_match_port(monkeypatch, fault, name):
    """The stabilized (Huber, bounds, beta-NLL, blind regulariser) and the
    raw NLL, and their gradients, in blocks of rows."""
    from ssdn_tpu_torch.train.step import make_train_step

    d = fp32(fields(name, batch_size=4))
    params = port_params(d)
    step = make_train_step(port_cfg(d), device="cpu")
    g = torch.Generator().manual_seed(9)
    y = torch.rand((4, 64, 64, 3), generator=g) - 0.5
    sigma = torch.full((4,), 0.1)
    loss, _, grads = step.loss_and_grads(params, None, y, {"sigma": sigma})
    if fault:  # the Huber threshold moved
        monkeypatch.setattr(ref, "HUBER", 0.5)
        monkeypatch.setattr(ref, "LOG2PI", 1.0)
    with ref.Precision("fp32") as p:
        rloss, rgrads = ref.loss_and_grads(p, params, y, sigma, d, block=3)
    gap = max(abs(rloss - float(loss)) / max(abs(float(loss)), 1e-3),
              max(_gap(rgrads[n][k], grads[n][k])
                  / max(float(grads[n][k].abs().max()), 1e-6)
                  for n in grads for k in grads[n]))
    assert (gap > 1e-3) == fault, gap


@pytest.mark.parametrize("fault", FAULTS)
def test_three_steps_match_port(monkeypatch, fault):
    """Initialisation, crops, the step's noise, the NLL and Adam: three
    steps of the fp32 configuration from the seed, by the numbers that
    decide a training cell's ``correct``."""
    from h100_bench import check
    from h100_bench.drivers.trainer import (_change, _delta, _diff_norms,
                                            _host, _norms)
    from ssdn_tpu_torch.train.step import init_state, make_train_step

    d = fields("ref_fp32", batch_size=4, seed=2 ** 40 + 11, iterations=50)
    images = corpus.training_corpus(d["seed"], 6, 80)
    cfg = port_cfg(d)
    step = make_train_step(cfg, device="cpu")
    state = init_state(cfg, device="cpu")
    p0, losses = state.params, []
    for s in range(3):
        state, m = step(state, ref.crops(images, d["seed"], s, 4, 64))
        losses.append(float(m["loss"]))
        if s == 0:
            mu1 = state.opt_state["mu"]
    if fault:  # Adam at half the configured learning rate
        real = ref.adam
        monkeypatch.setattr(ref, "adam", lambda p, o, g, s, c: real(
            p, o, g, s, dict(c, lr=c["lr"] * 0.5)))
    out = ref.train_steps(d, images, 3, "cpu", block=3)
    scale = 1 / (1 - d["adam_b1"])
    g0, want_g0 = _host(mu1, scale), _host(out["grad0"])
    keep = check.moving_elements(want_g0)
    got = check.training_readings(
        {"loss": losses, "init": _norms(p0), "grad0": _norms(mu1, scale),
         "change": _change(_delta(state.params, p0), keep),
         "grad0_diff": _diff_norms(g0, want_g0)},
        {"loss": out["loss"], "init": _norms(out["params0"]),
         "grad0": _norms(out["grad0"]),
         "change": _change(_delta(out["params"], out["params0"]), keep)})
    assert got["init_gap"] == 0 and got["grad_gap"] < 1e-4, got
    assert got["grad_diff"] < 1e-4, got
    assert (got["change_gap"] > 1e-2) == fault, got


@pytest.mark.parametrize("fault", FAULTS)
def test_crops_match_native_sampler(fault):
    """The reference's splitmix64 crops are the native sampler's bits."""
    from ssdn_tpu_torch.data import ArrayDataset
    from ssdn_tpu_torch.native import NativePatchSampler, available

    if not available():
        pytest.skip("no C++ compiler for the native sampler")
    images = corpus.training_corpus(4, 5, 96)
    seed = 2 ** 33 + 7
    got = NativePatchSampler(ArrayDataset(images), 64, 16, seed=seed).sample(3)
    want = ref.crops(images, seed, 4 if fault else 3, 16, 64)
    assert (not np.array_equal(got, want)) == fault


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["blind_bf16", "ref_fp32"])
def test_noise_matches_port(fault, name):
    """The step's noise: the sigma draw, then the Gaussian, from a generator
    seeded by (seed, step)."""
    from ssdn_tpu_torch.train.step import make_train_step

    d = fields(name, seed=2 ** 35 + 3)
    batch = np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3),
                                              dtype=np.uint8)
    x, y, nparams, _ = make_train_step(port_cfg(d), device="cpu").noisy_batch(
        batch, 5)
    rx, ry, rs = ref.noisy(batch, d, 6 if fault else 5, "cpu")
    assert torch.equal(rx, x)
    assert (not torch.equal(ry, y)) == fault
    assert (not torch.equal(rs, nparams["sigma"])) == (
        fault and name == "blind_bf16")


@pytest.mark.parametrize("fault", FAULTS)
def test_init_matches_port(fault):
    """He-normal weights from the seed, layer by layer, zero biases."""
    from ssdn_tpu_torch.train.step import init_state

    d = fields("blind_bf16", seed=2 ** 31 + 1)
    params = init_state(port_cfg(d), device="cpu").params
    shapes = ref.layer_shapes(3, ref.n_outputs(3, True), 48, 96, 384, 96)
    if fault:  # two layers drawn in the other order
        keys = list(shapes)
        keys[0], keys[1] = keys[1], keys[0]
        shapes = {k: shapes[k] for k in keys}
    got = ref.he_init(d["seed"], shapes, "cpu")
    same = all(torch.equal(got[n][k], params[n][k]) for n in params
               for k in params[n])
    assert same != fault
