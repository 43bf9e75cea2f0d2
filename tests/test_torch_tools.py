"""The port's tools (``ssdn_tpu_torch/tools``: export_pretrained,
blind_calibration, parity_check) and debug helpers
(``ssdn_tpu_torch/utils/debug.py``) on the CPU, each against the JAX
package's counterpart where one can be run on the same inputs."""

import argparse
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdn_tpu import zoo as jzoo
from ssdn_tpu.estimator.core import _ALPHA_HI, _ALPHA_LO
from ssdn_tpu.estimator.core import estimate_sigma as jestimate_sigma
from ssdn_tpu.infer import full as jfull
from ssdn_tpu_torch.config import NoiseModel
from ssdn_tpu_torch.data import open_dataset
from ssdn_tpu_torch.infer import evaluate_dataset
from ssdn_tpu_torch.infer import full as tfull
from ssdn_tpu_torch.tools import blind_calibration, export_pretrained
from ssdn_tpu_torch.tools import parity_check
from ssdn_tpu_torch.train.loop import load_config
from ssdn_tpu_torch.utils import debug

TRAIN_TINY = ["--enc-features", "8", "--dec-features", "16",
              "--nin-a-features", "32", "--nin-b-features", "16",
              "--batch-size", "2", "--patch-size", "32"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _train(wd, *extra):
    from ssdn_tpu_torch.cli.train import main as train_main

    train_main(["--device", "cpu", "--compute-dtype", "float32",
                "--workdir", str(wd), "--train-data", "synthetic:8:64",
                "--iterations", "2", "--eval-interval", "0",
                "--snapshot-interval", "2", "--log-interval", "0",
                *TRAIN_TINY, *extra])
    return wd


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("tools") / "wd")


# ------------------------------ export ------------------------------


def test_export_is_served_by_the_jax_package(workdir, tmp_path):
    """The exported .npz loads in the JAX package, whose forward on those
    params matches the port's on its workdir's params at 1e-4."""
    from ssdn_tpu_torch.cli.evaluate import _load_model

    out = tmp_path / "m.npz"
    export_pretrained.main([str(workdir), str(out), "--device", "cpu",
                            "--note", "tiny"])
    jcfg, jparams, meta = jzoo.load(str(out))
    assert meta == {"step": 2, "noise": "gauss sigma=25 (known)",
                    "which": "auto", "note": "tiny"}
    cfg, params, _ = _load_model(argparse.Namespace(
        pretrained=None, workdir=str(workdir), which="auto", device="cpu"))
    rng = np.random.default_rng(4)
    noisy = rng.uniform(-0.5, 0.5, (32, 64, 3)).astype(np.float32)
    sigma = np.full((1,), 25 / 255, np.float32)
    theirs = jfull.denoise_image(jfull.make_denoise_fn(jcfg), jparams, noisy,
                                 jnp.asarray(sigma))
    ours = tfull.denoise_image(tfull.make_denoise_fn(cfg, device="cpu"),
                               params, noisy, sigma)
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_export_eval_records_the_ports_psnr(workdir, tmp_path):
    from ssdn_tpu_torch import zoo
    from ssdn_tpu_torch.train.loop import CheckpointManager
    from ssdn_tpu_torch.train.step import init_state

    out = tmp_path / "m.npz"
    export_pretrained.main([str(workdir), str(out), "--device", "cpu",
                            "--eval", "synthetic:2:64", "--which", "latest"])
    _, _, meta = zoo.load(str(out))
    cfg = load_config(str(workdir))
    state = CheckpointManager(str(workdir), cfg).restore(
        init_state(cfg, device="cpu"))
    res = evaluate_dataset(cfg, state.params, open_dataset("synthetic:2:64"),
                           device="cpu")
    assert meta["which"] == "latest"
    assert meta["eval"] == {"synthetic:2:64": {
        "psnr_mean": round(res["psnr_mean"], 3),
        "noisy_psnr_mean": round(res["noisy_psnr_mean"], 3),
        "noise": "gauss sigma=25 (known)"}}


# ------------------------- blind calibration -------------------------


def _jax_estimates(out, model, c):
    """The JAX tool's per-model formula (``tools/blind_calibration.py``)."""
    t = c * (c + 1) // 2
    ch = jnp.asarray(out)[..., c + t]
    if model == NoiseModel.GAUSSIAN:
        return np.asarray(jestimate_sigma(ch)) * 255.0
    if model == NoiseModel.POISSON:
        s = np.asarray(jestimate_sigma(ch))
        return 0.5 / (s ** 2 + 1e-8)
    m = np.asarray(jnp.mean(jax.nn.sigmoid(ch), axis=(1, 2)))
    return (_ALPHA_LO + (_ALPHA_HI - _ALPHA_LO) * m) * 100.0


@pytest.mark.parametrize("model", list(NoiseModel))
@pytest.mark.parametrize("c", [1, 3])
def test_calibration_estimates_are_the_jax_tools(model, c):
    rng = np.random.default_rng(c)
    out = (2 * rng.standard_normal((3, 16, 24, c + c * (c + 1) // 2 + 1))
           ).astype(np.float32)
    ours = blind_calibration.estimates(torch.from_numpy(out), model, c)
    np.testing.assert_allclose(ours, _jax_estimates(out, model, c),
                               rtol=1e-5)


def test_calibration_runs_on_the_cpu(tmp_path, capsys):
    wd = _train(tmp_path / "blind", "--noise-style", "gauss5_50",
                "--blind", "variable")
    capsys.readouterr()
    out = tmp_path / "cal.json"
    blind_calibration.main([str(wd), "--values", "10,40", "--images", "2",
                            "--size", "32", "--device", "cpu",
                            "--json-out", str(out)])
    table = capsys.readouterr().out
    assert "| true sigma (0-255) | estimate (mean ± std, 2 images) |" in table
    rows = json.loads(out.read_text())
    assert [r["true"] for r in rows] == [10.0, 40.0]
    assert all(math.isfinite(r[k]) for r in rows
               for k in ("est_mean", "est_std", "psnr"))
    with pytest.raises(SystemExit, match="variable-blind"):
        blind_calibration.main([str(_train(tmp_path / "known")),
                                "--device", "cpu"])


# --------------------------- parity check ---------------------------


def test_parity_check_trains_both_arms(tmp_path, capsys):
    table = parity_check.main([
        "2", "synthetic:4:32", "synthetic:1:32", "--device", "cpu",
        "--workroot", str(tmp_path), "--eval-interval", "2", *TRAIN_TINY])
    assert sorted(table) == sorted(parity_check.ARMS)
    for arm, evals in table.items():
        assert list(evals) == [2] and math.isfinite(evals[2]), arm
        cfg = load_config(str(tmp_path / f"parity_{arm}"))
        assert cfg.iterations == 2 and cfg.model.enc_features == 8
    assert load_config(str(tmp_path / "parity_reference_objective")
                       ).objective == "reference"
    assert "| step | stabilized_bf16 | reference_objective |" in (
        capsys.readouterr().out)


# ------------------------------- debug -------------------------------


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_assert_finite_tree_names_the_leaf(bad):
    tree = {"enc0": {"w": torch.ones(2, 3)},
            "opt": [{"m": np.zeros(2)}, {"v": torch.tensor([1.0, bad])}]}
    with pytest.raises(AssertionError, match="opt/1/v"):
        debug.assert_finite_tree(tree)
    tree["opt"][1]["v"][1] = 2.0
    debug.assert_finite_tree(tree)


def test_debug_nans_raises_on_a_nan_made_in_the_backward():
    x = torch.zeros(2, requires_grad=True)
    assert not torch.is_anomaly_enabled()
    with pytest.raises(RuntimeError, match="nan"):
        with debug.debug_nans():
            assert torch.is_anomaly_enabled()
            (torch.sqrt(x) * 0).sum().backward()
    assert not torch.is_anomaly_enabled()
    (torch.sqrt(x) * 0).sum().backward()  # off: the NaN passes
    assert torch.isnan(x.grad).all()
    torch.autograd.set_detect_anomaly(True)
    try:
        with debug.debug_nans(False):
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_profile_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "prof"
    with debug.profile_trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((logdir / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
