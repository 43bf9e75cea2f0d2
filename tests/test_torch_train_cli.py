"""The port's training CLI (``ssdn_tpu_torch/cli/train.py``) on the CPU:
the same configs as the JAX package's CLI from the same argv, a tiny run
that writes a workdir, and serving from that workdir through
``cli.denoise --workdir`` — the port's version of
``tests/test_denoise_cli.py``."""

import json
import os

import numpy as np
import pytest
import torch

from ssdn_tpu.cli.train import build_parser as jbuild_parser
from ssdn_tpu.cli.train import config_from_args as jconfig_from_args
from ssdn_tpu.config import to_json as jto_json
from ssdn_tpu_torch.cli.train import build_parser, config_from_args
from ssdn_tpu_torch.cli.train import main as train_main
from ssdn_tpu_torch.config import to_json

TINY = ["--enc-features", "8", "--dec-features", "16",
        "--nin-a-features", "32", "--nin-b-features", "16"]


@pytest.mark.parametrize("argv", [
    [],
    ["--algorithm", "n2n", "--noise-style", "poisson30", "--grayscale",
     "--patch-size", "32", "--compute-dtype", "float32"],
    ["--noise-style", "gauss5_50", "--blind"],
    ["--noise-style", "impulse30_60", "--blind", "const", "--objective",
     "reference", "--conv-backend", "pallas", "--lr", "1e-3",
     "--grad-clip", "1.0", "--blind-reg-rampdown", "0.3"],
    ["--algorithm", "ssdn_mse", "--eval-patience", "3",
     "--eval-patience-delta", "0.5", "--snapshot-interval", "7",
     "--batch-size", "384", "--decoder-mode", "naive", *TINY],
], ids=["defaults", "n2n-poisson-gray", "blind", "blind-const-reference",
        "mse-widths"])
def test_config_from_args_is_the_jax_packages(argv):
    argv = ["--workdir", "/tmp/x", *argv]
    ours = config_from_args(build_parser().parse_args(argv))
    theirs = jconfig_from_args(jbuild_parser().parse_args(argv))
    assert to_json(ours) == jto_json(theirs)


def test_the_flags_are_the_jax_packages_plus_device():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert flags(build_parser()) == flags(jbuild_parser()) | {"--device"}
    assert build_parser().parse_args(["--workdir", "w"]).device == "cuda"


def test_cli_needs_a_gpu_unless_cpu_and_refuses_data_parallel(tmp_path):
    argv = ["--workdir", str(tmp_path / "w"), "--train-data", "synthetic:2:32",
            "--iterations", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_main(argv)
    # --data-parallel without a launcher trains a group of one (gloo on
    # the CPU); tests/test_torch_parallel.py runs 2 ranks through torchrun
    train_main([*argv, "--device", "cpu", "--data-parallel", "--batch-size",
                "2", "--patch-size", "32", "--enc-features", "8",
                "--dec-features", "16", "--nin-a-features", "32",
                "--nin-b-features", "16", "--log-interval", "1"])
    assert (tmp_path / "w" / "ckpt" / f"step_{1:010d}.pt").exists()


def test_cli_trains_on_the_cpu_and_writes_its_workdir(tmp_path, capsys):
    wd = tmp_path / "run"
    train_main([
        "--device", "cpu", "--workdir", str(wd),
        "--train-data", "synthetic:8:64", "--eval-data", "synthetic:2:64",
        "--iterations", "4", "--batch-size", "2", "--patch-size", "32",
        "--eval-interval", "2", "--snapshot-interval", "2",
        "--log-interval", "2", "--compute-dtype", "float32",
        "--sampler-backend", "native", *TINY,
    ])
    out = capsys.readouterr().out
    assert "[4/4] loss" in out and "[eval @ 4]" in out
    with open(wd / "config.json") as f:
        assert json.load(f)["iterations"] == 4
    with open(wd / "sampler_backend.json") as f:
        assert json.load(f) == {"backend": "native"}
    rows = [json.loads(line) for line in open(wd / "metrics.jsonl")]
    train = [r for r in rows if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [2, 4]
    assert all(np.isfinite(r["loss"]) and r["patches_per_sec"] > 0
               for r in train)
    assert [r["step"] for r in rows if r["prefix"] == "eval"] == [2, 4]
    assert sorted(os.listdir(wd / "ckpt")) == ["step_0000000002.pt",
                                               "step_0000000004.pt"]
    assert len(os.listdir(wd / "ckpt_best")) == 1
    with open(wd / "best_psnr.json") as f:
        assert json.load(f)["step"] in (2, 4)
    # a second run resumes at the last step and has nothing left to do
    train_main(["--device", "cpu", "--workdir", str(wd), "--train-data",
                "synthetic:8:64", "--iterations", "4", "--batch-size", "2",
                "--patch-size", "32", "--compute-dtype", "float32", *TINY])
    assert "resumed from step 4" in capsys.readouterr().out


# ------------ the port's version of tests/test_denoise_cli.py ------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    wd = tmp_path_factory.mktemp("denoisecli")
    # narrow net + few steps: this fixture only needs a model that beats
    # the noisy input; fp32, since bf16 convolutions are slow on the CPU
    train_main([
        "--device", "cpu", "--compute-dtype", "float32",
        "--workdir", str(wd), "--train-data", "synthetic:16:64",
        "--iterations", "40", "--batch-size", "4", "--patch-size", "32",
        "--eval-interval", "0", "--snapshot-interval", "40",
        "--log-interval", "0",
        "--enc-features", "16", "--dec-features", "32",
        "--nin-a-features", "64", "--nin-b-features", "32",
    ])
    return wd


def denoise_main(argv):
    from ssdn_tpu_torch.cli.denoise import main

    main(["--device", "cpu", *argv])


def _write_noisy(tmp_path, n=2, size=64, sigma=25.0, seed=7):
    from ssdn_tpu_torch.data import synthetic_dataset
    from ssdn_tpu_torch.utils import save_image

    rng = np.random.default_rng(seed)
    ds = synthetic_dataset(n=n, size=size, channels=3, seed=seed)
    indir = tmp_path / "noisy"
    cleans = []
    for i in range(n):
        clean = np.asarray(ds[i], np.float32) / 255.0
        noisy = clean + rng.normal(0, sigma / 255.0, clean.shape)
        save_image(str(indir / f"img{i}.png"),
                   (np.clip(noisy, 0, 1) * 255).round().astype(np.uint8))
        cleans.append(clean)
    return indir, cleans


def test_denoise_folder(trained, tmp_path):
    from ssdn_tpu_torch.utils import load_image

    indir, cleans = _write_noisy(tmp_path)
    outdir = tmp_path / "out"
    denoise_main([
        "--workdir", str(trained), "--input", str(indir),
        "--output", str(outdir), "--param", "25",
    ])
    outs = sorted(outdir.glob("*_denoised.png"))
    assert len(outs) == len(cleans)
    for out, clean in zip(outs, cleans):
        den = np.asarray(load_image(str(out)), np.float32) / 255.0
        noisy = np.asarray(
            load_image(str(indir / out.name.replace("_denoised", ""))),
            np.float32) / 255.0
        mse_d = float(np.mean((den - clean) ** 2))
        mse_n = float(np.mean((noisy - clean) ** 2))
        assert mse_d < mse_n, (mse_d, mse_n)


def test_denoise_single_file_sequential(trained, tmp_path):
    indir, _ = _write_noisy(tmp_path, n=1)
    outdir = tmp_path / "out_seq"
    denoise_main([
        "--workdir", str(trained), "--input", str(indir / "img0.png"),
        "--output", str(outdir), "--tiled", "sequential",
        "--tile-w", "32", "--halo", "32",
    ])
    assert (outdir / "img0_denoised.png").exists()


def test_denoise_rerun_and_extension_collision(trained, tmp_path):
    """img.png + img.jpg in one folder uniquify; re-running into the same
    output dir refreshes the canonical paths."""
    import shutil

    indir, _ = _write_noisy(tmp_path, n=1)
    shutil.copyfile(indir / "img0.png", indir / "img0.jpg")
    outdir = tmp_path / "out_coll"
    args = ["--workdir", str(trained), "--input", str(indir),
            "--output", str(outdir), "--param", "25"]
    denoise_main(args)
    canonical = outdir / "img0_denoised.png"
    uniquified = {p.name for p in outdir.glob("*_denoised.png")} - {
        canonical.name}
    assert canonical.exists()
    assert len(uniquified) == 1
    before = canonical.stat().st_mtime_ns
    denoise_main(args)
    assert {p.name for p in outdir.glob("*_denoised.png")} == (
        uniquified | {canonical.name})
    assert canonical.stat().st_mtime_ns > before


def test_denoise_default_param_from_config(trained, tmp_path, capsys):
    indir, _ = _write_noisy(tmp_path, n=1)
    outdir = tmp_path / "out_def"
    denoise_main([
        "--workdir", str(trained), "--input", str(indir),
        "--output", str(outdir), "--which", "latest",
    ])
    assert (outdir / "img0_denoised.png").exists()
    assert "checkpoint step: 40" in capsys.readouterr().out
