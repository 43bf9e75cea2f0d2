"""The port's evaluation (``ssdn_tpu_torch/infer/full.py::evaluate_dataset``
and ``ssdn_tpu_torch/cli/evaluate.py``) on the CPU: PSNR parity with the JAX
package's ``evaluate_dataset`` at identical weights and identical noisy
images, batched against per-image eval, the refusals, and the port's
version of ``tests/test_evaluate_cli.py`` (all but its data-parallel test:
data parallelism is not ported yet). The sequential tiled mode is tested in
``tests/test_torch_tiled.py``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.infer.full as jfull
from ssdn_tpu.config import ModelConfig as JModelConfig
from ssdn_tpu.config import TrainConfig as JTrainConfig
from ssdn_tpu.config import parse_noise_style as jparse_noise_style
from ssdn_tpu.train.step import init_state as jinit_state
from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style
from ssdn_tpu_torch.data import open_dataset
from ssdn_tpu_torch.infer import evaluate_dataset
from ssdn_tpu_torch.infer import full as tfull
from ssdn_tpu_torch.models.blindspot_unet import params_from_jax
from ssdn_tpu_torch.parallel import Group
from ssdn_tpu_torch.train.loop import load_config
from ssdn_tpu_torch.train.step import init_state
from ssdn_tpu_torch.utils.images import to_internal

TINY = dict(enc_features=8, dec_features=16, nin_a_features=32,
            nin_b_features=16, compute_dtype="float32")
# fp32 forwards of the same weights on the same image differ by summation
# order only (~1e-6 of the range): the PSNRs agree to 1e-3 dB and the
# denoised images to 1e-4
PSNR_ATOL_DB = 1e-3
IMAGE_ATOL = 1e-4


def _numpy_injector(dataset, sigma=25.0):
    """add_noise for either package: Gaussian noise from a numpy generator
    keyed by the index of the clean image in ``dataset``, so both packages
    score the same noisy images."""
    cleans = [to_internal(dataset[i]) for i in range(len(dataset))]

    def noisy(clean):
        clean = np.asarray(clean)[0]
        i = next(k for k, c in enumerate(cleans) if np.array_equal(c, clean))
        rng = np.random.default_rng(np.random.SeedSequence([7, i]))
        y = clean + sigma / 255.0 * rng.standard_normal(clean.shape)
        return y.astype(np.float32)[None], np.full((1,), sigma / 255.0,
                                                    np.float32)

    def jax_add_noise(key, x, noise):
        y, s = noisy(x)
        return jnp.asarray(y), {"sigma": jnp.asarray(s)}

    def torch_add_noise(gen, x, noise):
        y, s = noisy(x.cpu().numpy())
        return (torch.from_numpy(y).to(x.device),
                {"sigma": torch.from_numpy(s).to(x.device)})

    return jax_add_noise, torch_add_noise


def test_psnr_matches_the_jax_package_at_identical_weights(monkeypatch):
    jcfg = JTrainConfig(noise=jparse_noise_style("gauss25"),
                        model=JModelConfig(in_channels=3, **TINY),
                        patch_size=32, batch_size=2)
    cfg = TrainConfig(noise=parse_noise_style("gauss25"),
                      model=ModelConfig(in_channels=3, **TINY),
                      patch_size=32, batch_size=2)
    tree = {k: {n: np.asarray(v) for n, v in leaf.items()}
            for k, leaf in jinit_state(jcfg).params.items()}
    ds = open_dataset("synthetic:3:64")
    jax_noise, torch_noise = _numpy_injector(ds)
    monkeypatch.setattr(jfull, "add_noise", jax_noise)
    monkeypatch.setattr(tfull, "add_noise", torch_noise)
    theirs = jfull.evaluate_dataset(jcfg, tree, ds, eval_batch=3,
                                    return_images=3)
    params = params_from_jax(tree, device="cpu")
    for eval_batch in (1, 2):
        ours = evaluate_dataset(cfg, params, ds, eval_batch=eval_batch,
                                return_images=3, device="cpu")
        np.testing.assert_allclose(ours["psnr_per_image"],
                                   theirs["psnr_per_image"],
                                   atol=PSNR_ATOL_DB)
        np.testing.assert_allclose(ours["noisy_psnr_mean"],
                                   theirs["noisy_psnr_mean"], rtol=0,
                                   atol=1e-9)
        for a, b in zip(ours["images"], theirs["images"]):
            np.testing.assert_array_equal(a["noisy"], b["noisy"])
            np.testing.assert_allclose(a["denoised"], b["denoised"],
                                       atol=IMAGE_ATOL)
        assert ours["n_images"] == 3



@pytest.mark.parametrize("world", [2, 4])
def test_group_eval_equals_one_process(world):
    """``evaluate_dataset`` over gloo ranks: mode "full" with a group (DP
    eval: 3 images at eval_batch 3, padded to a multiple of the world
    size, each rank denoising its rows) and the sharded modes, against
    one process's mode "full"; every rank returns the same dict."""
    import torch_dist

    jcfg = JTrainConfig(noise=jparse_noise_style("gauss25"),
                        model=JModelConfig(in_channels=3, **TINY))
    cfg = TrainConfig(noise=parse_noise_style("gauss25"),
                      model=ModelConfig(in_channels=3, **TINY))
    tree = {k: {n: np.asarray(v) for n, v in leaf.items()}
            for k, leaf in jinit_state(jcfg).params.items()}
    # 128 px: a multiple of 32 * world, so the per-level strips need no
    # pad beyond the untiled image's (tiled_denoise_perlevel's docstring)
    ref = evaluate_dataset(cfg, params_from_jax(tree, device="cpu"),
                           open_dataset("synthetic:3:128"), return_images=1,
                           device="cpu")
    modes = [("full", 3), ("sharded", 1), ("sharded-window", 1)]
    runs = torch_dist.run(torch_dist.evaluate, world, cfg, tree,
                          "synthetic:3:128", modes)
    for mode, _ in modes:
        ours = runs[0][mode]
        for r in range(1, world):
            assert runs[r][mode]["psnr_per_image"] == ours["psnr_per_image"]
            np.testing.assert_array_equal(runs[r][mode]["denoised0"],
                                          ours["denoised0"])
        assert ours["n_images"] == 3
        np.testing.assert_allclose(ours["psnr_per_image"],
                                   ref["psnr_per_image"], atol=PSNR_ATOL_DB,
                                   err_msg=mode)
        assert ours["noisy_psnr_mean"] == ref["noisy_psnr_mean"]
        np.testing.assert_allclose(ours["denoised0"],
                                   ref["images"][0]["denoised"],
                                   atol=IMAGE_ATOL, err_msg=mode)

def test_eval_noise_is_per_image_and_repeatable():
    cfg = TrainConfig(noise=parse_noise_style("gauss25"),
                      model=ModelConfig(in_channels=3, **TINY))
    params = init_state(cfg, device="cpu").params
    ds = open_dataset("synthetic:2:64")
    a = evaluate_dataset(cfg, params, ds, return_images=2, device="cpu")
    b = evaluate_dataset(cfg, params, ds, return_images=2, device="cpu")
    np.testing.assert_array_equal(a["images"][1]["noisy"],
                                  b["images"][1]["noisy"])
    assert not np.array_equal(a["images"][0]["noisy"] - a["images"][0]["clean"],
                              a["images"][1]["noisy"] - a["images"][1]["clean"])
    c = evaluate_dataset(cfg, params, ds, seed=1, device="cpu")
    assert c["noisy_psnr_mean"] != a["noisy_psnr_mean"]


def test_streaming_refused_and_tiled_modes_raise():
    cfg = TrainConfig(model=ModelConfig(**TINY))
    with pytest.raises(ValueError, match="finite"):
        evaluate_dataset(cfg, None, open_dataset("synthetic:inf:64"))
    ds = open_dataset("synthetic:1:32")
    for mode in ("sharded", "sharded-window"):
        with pytest.raises(ValueError, match="process group"):
            evaluate_dataset(cfg, None, ds, mode=mode, device="cpu")
    two = Group(rank=0, world=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="eval_batch > 1"):
        evaluate_dataset(cfg, None, ds, device="cpu", group=two)
    with pytest.raises(ValueError, match="requires mode='full'"):
        evaluate_dataset(cfg, None, ds, mode="sequential", eval_batch=2)


def test_evaluate_needs_a_gpu_unless_cpu():
    cfg = TrainConfig(model=ModelConfig(**TINY))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate_dataset(cfg, None, open_dataset("synthetic:1:32"))


# ------------ the port's version of tests/test_evaluate_cli.py ------------

TRAIN_TINY = ["--enc-features", "8", "--dec-features", "16",
              "--nin-a-features", "32", "--nin-b-features", "16"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from ssdn_tpu_torch.cli.train import main as train_main

    wd = tmp_path_factory.mktemp("evalcli")
    train_main([
        "--device", "cpu",
        "--workdir", str(wd), "--train-data", "synthetic:8:64",
        "--eval-data", "synthetic:2:64", "--iterations", "4",
        "--batch-size", "2", "--patch-size", "32",
        "--eval-interval", "0", "--snapshot-interval", "4",
        "--log-interval", "0", *TRAIN_TINY,
    ])
    return wd


def eval_main(argv):
    from ssdn_tpu_torch.cli.evaluate import main

    main(["--device", "cpu", *argv])


def test_multi_dataset_table_json(workdir, tmp_path, capsys):
    out = tmp_path / "table.json"
    eval_main([
        "--workdir", str(workdir),
        "--dataset", "synthetic:2:64",
        "--dataset", "synthetic:3:64,synthetic:1:64",
        "--json-out", str(out),
    ])
    assert "PSNR table" in capsys.readouterr().out
    payload = json.loads(out.read_text())
    table = payload["table"]
    assert set(table) == {"synthetic:2:64", "synthetic:3:64", "synthetic:1:64"}
    assert table["synthetic:3:64"]["n_images"] == 3
    for row in table.values():
        assert row["psnr_mean"] > 0 and row["noisy_psnr_mean"] > 0
    assert len(payload["datasets"]["synthetic:1:64"]["psnr_per_image"]) == 1


def test_save_images_duplicate_spec_distinct_dirs(workdir, tmp_path):
    imgdir = tmp_path / "imgs"
    eval_main([
        "--workdir", str(workdir),
        "--dataset", "synthetic:1:64",
        "--dataset", "synthetic:1:64",
        "--save-images", str(imgdir),
    ])
    subdirs = sorted(p.name for p in imgdir.iterdir() if p.is_dir())
    assert subdirs == ["00_synthetic_1_64", "01_synthetic_1_64"]
    for sub in subdirs:
        assert sorted(p.name for p in (imgdir / sub).glob("*.png")) == [
            "000_clean.png", "000_denoised.png", "000_noisy.png"]


def test_single_dataset_json_backward_compatible(workdir, tmp_path):
    out = tmp_path / "single.json"
    eval_main([
        "--workdir", str(workdir),
        "--dataset", "synthetic:2:64",
        "--json-out", str(out),
        "--which", "latest", "--eval-batch", "2",
    ])
    payload = json.loads(out.read_text())
    assert "psnr_mean" in payload and "psnr_per_image" in payload


def test_cli_refuses_what_is_not_ported(workdir, tmp_path):
    """Everything is ported: the sharded modes and --data-parallel run a
    group of one without a launcher and score as --tiled full does; the
    CLI still refuses a checkpoint the workdir does not hold."""
    runs = {}
    for name, extra in (("full", []), ("sharded", ["--tiled", "sharded"]),
                        ("window", ["--tiled", "sharded-window"]),
                        ("dp", ["--data-parallel"])):
        out = tmp_path / f"{name}.json"
        eval_main(["--workdir", str(workdir), "--dataset", "synthetic:2:64",
                   "--device", "cpu", "--json-out", str(out), *extra])
        runs[name] = json.loads(out.read_text())["psnr_per_image"]
    # window and DP eval run the full image's forward; the per-level trunk
    # ("sharded") is the literal program, whose bf16 roundings (this
    # workdir trains in bf16) differ from the fused decoder's
    for name in ("window", "dp"):
        np.testing.assert_allclose(runs[name], runs["full"], atol=1e-3)
    np.testing.assert_allclose(runs["sharded"], runs["full"], atol=0.05)
    with pytest.raises(FileNotFoundError, match="ckpt_best"):
        eval_main(["--workdir", str(workdir), "--dataset", "synthetic:1:64",
                   "--which", "best"])


def test_batched_eval_matches_per_image(workdir):
    cfg = load_config(str(workdir))
    params = init_state(cfg, device="cpu").params
    ds = open_dataset("synthetic:5:64")
    a = evaluate_dataset(cfg, params, ds, eval_batch=1, device="cpu")
    b = evaluate_dataset(cfg, params, ds, eval_batch=3, device="cpu")
    np.testing.assert_allclose(a["psnr_per_image"], b["psnr_per_image"],
                               atol=1e-3)
    assert b["n_images"] == 5


def _tiny_cfg(style, blind=False):
    return TrainConfig(
        noise=parse_noise_style(style, blind=blind),
        model=ModelConfig(in_channels=3, **TINY),
        patch_size=32, batch_size=2, iterations=4,
    )


def test_batched_eval_poisson_and_impulse():
    """Per-image (B,) noise-parameter vectors broadcast as batch, not
    channels, in the Poisson/impulse estimators."""
    ds = open_dataset("synthetic:4:64")
    for style in ("poisson30", "impulse50"):
        cfg = _tiny_cfg(style)
        params = init_state(cfg, device="cpu").params
        a = evaluate_dataset(cfg, params, ds, eval_batch=1, device="cpu")
        b = evaluate_dataset(cfg, params, ds, eval_batch=4, device="cpu")
        np.testing.assert_allclose(a["psnr_per_image"], b["psnr_per_image"],
                                   atol=1e-3, err_msg=style)


def test_noise_style_override_preserves_blind_const(tmp_path, capsys):
    from ssdn_tpu_torch.cli.train import main as train_main

    wd = tmp_path / "bc"
    train_main([
        "--device", "cpu",
        "--workdir", str(wd), "--train-data", "synthetic:8:64",
        "--eval-data", "synthetic:2:64", "--iterations", "4",
        "--batch-size", "2", "--patch-size", "32",
        "--eval-interval", "0", "--snapshot-interval", "4",
        "--log-interval", "0", "--noise-style", "gauss25",
        "--blind", "const", *TRAIN_TINY,
    ])
    capsys.readouterr()
    eval_main([
        "--workdir", str(wd),
        "--dataset", "synthetic:2:64",
        "--noise-style", "gauss30",
    ])
    assert "gauss sigma=30 (blind_const)" in capsys.readouterr().out


def test_batched_eval_blind_modes():
    ds = open_dataset("synthetic:4:64")
    for style in ("gauss5_50", "poisson5_50", "impulse30_60"):
        cfg = _tiny_cfg(style, blind=True)
        params = init_state(cfg, device="cpu").params
        a = evaluate_dataset(cfg, params, ds, eval_batch=1, device="cpu")
        b = evaluate_dataset(cfg, params, ds, eval_batch=4, device="cpu")
        np.testing.assert_allclose(a["psnr_per_image"], b["psnr_per_image"],
                                   atol=1e-3, err_msg=style)
