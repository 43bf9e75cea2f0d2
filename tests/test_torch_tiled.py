"""The port's sequential tiled inference (``ssdn_tpu_torch/infer/tiled.py``,
mode "sequential" of ``evaluate_dataset``, ``--tiled sequential`` of
``cli.denoise`` and ``cli.evaluate``) on the CPU, against the JAX package's
``tiled_denoise_sequential`` at identical weights and numpy inputs, and
against the port's own full-image path.

The images are 32 rows high and up to 1024 columns wide, the model TINY
(as in ``tests/test_tiled.py``): with ``tile_w`` 128 and the exact halo of
320 a 1024-wide image runs 8 windows of 768 columns, clamped inside the
image at both ends, so the window arithmetic is exercised; a 512-wide one
is a single window (the JAX package's test shape). fp32 on both sides: the
two frameworks differ only in summation order, hence rtol = atol = 1e-4
(``tests/test_torch_denoise.py``).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.infer.full as jfull
from ssdn_tpu.config import ModelConfig as JModelConfig
from ssdn_tpu.config import TrainConfig as JTrainConfig
from ssdn_tpu.config import parse_noise_style as jparse_noise_style
from ssdn_tpu.infer.tiled import HALO_EXACT as J_HALO_EXACT
from ssdn_tpu.infer.tiled import tiled_denoise_sequential as jsequential
from ssdn_tpu.train.step import init_state as jinit_state
from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style
from ssdn_tpu_torch.infer import evaluate_dataset
from ssdn_tpu_torch.infer import full as tfull
from ssdn_tpu_torch.infer.tiled import HALO_EXACT, tiled_denoise_sequential
from ssdn_tpu_torch.models import blindspot_unet as bu
from ssdn_tpu_torch.models.blindspot_unet import params_from_jax
from ssdn_tpu_torch.utils.images import to_internal

TINY = dict(enc_features=8, dec_features=16, nin_a_features=32,
            nin_b_features=16, compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
PSNR_ATOL_DB = 1e-3
TILE_W = 128
SIGMA = np.full((1,), 25 / 255, np.float32)
TRAIN_TINY = ["--enc-features", "8", "--dec-features", "16",
              "--nin-a-features", "32", "--nin-b-features", "16"]


def _configs(style="gauss25", blind=False, **model):
    jcfg = JTrainConfig(noise=jparse_noise_style(style, blind=blind),
                        model=JModelConfig(in_channels=3, **TINY, **model))
    cfg = TrainConfig(noise=parse_noise_style(style, blind=blind),
                      model=ModelConfig(in_channels=3, **TINY, **model))
    return jcfg, cfg


def _weights(jcfg):
    """The JAX package's init as host numpy, and the port's tensors."""
    tree = {k: {n: np.asarray(v) for n, v in leaf.items()}
            for k, leaf in jinit_state(jcfg).params.items()}
    return tree, params_from_jax(tree, device="cpu")


def _noisy(w, h=32, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (h, w, 3)).astype(np.float32)


def test_halo_exact_is_the_jax_packages():
    assert HALO_EXACT == J_HALO_EXACT == 320


# known: Gaussian sigma 25; blind: variable-blind sigma 5-50, whose noise
# level is estimated per window (as the JAX package does in this mode);
# ragged: widths that are no multiple of tile_w (and, at 992, of the window
# stride either)
@pytest.mark.parametrize("style,blind,w", [
    ("gauss25", False, 512),
    ("gauss25", False, 1024),
    ("gauss5_50", "variable", 1024),
    ("gauss25", False, 480),
    ("gauss25", False, 992),
], ids=["known-512", "known-1024", "blind-1024", "ragged-480", "ragged-992"])
def test_sequential_matches_the_jax_package(style, blind, w):
    jcfg, cfg = _configs(style, blind)
    tree, params = _weights(jcfg)
    noisy = _noisy(w)
    theirs = jsequential(jcfg, tree, noisy, jnp.asarray(SIGMA),
                         tile_w=TILE_W, halo=J_HALO_EXACT)
    ours = tiled_denoise_sequential(cfg, params, noisy, SIGMA,
                                    tile_w=TILE_W, device="cpu")
    assert ours.shape == noisy.shape
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_blind_sequential_estimates_per_window():
    """The variable-blind model's windows each estimate their own noise
    level, so on an image whose windows differ the tiled result is not the
    full-image one (it is the JAX package's, above)."""
    _, cfg = _configs("gauss5_50", "variable")
    params = bu.init_params(torch.Generator().manual_seed(0), 3, 10, enc=8,
                            dec=16, nin_a=32, nin_b=16)
    noisy = _noisy(1024)
    noisy[:, 512:] *= 0.2  # the right half is far less noisy
    tiled = tiled_denoise_sequential(cfg, params, noisy, SIGMA,
                                     tile_w=TILE_W, device="cpu")
    whole = tfull.denoise_image(tfull.make_denoise_fn(cfg, device="cpu"),
                                params, noisy, SIGMA)
    assert np.abs(tiled - whole).max() > 1e-3


@pytest.mark.parametrize("conv,head", [("lax", "lax"), ("lax", "pallas"),
                                       ("pallas", "lax")],
                         ids=["lax", "head_pallas", "conv_pallas"])
def test_sequential_equals_full_in_each_arm(conv, head):
    """The port's tiling against its own full-image path, in the torch-ops
    arm and both kernel arms (their plain twins on the CPU)."""
    jcfg, cfg = _configs(conv_backend=conv, head_backend=head)
    _, params = _weights(jcfg)
    noisy = _noisy(1024)
    whole = tfull.denoise_image(tfull.make_denoise_fn(cfg, device="cpu"),
                                params, noisy, SIGMA)
    tiled = tiled_denoise_sequential(cfg, params, noisy, SIGMA,
                                     tile_w=TILE_W, device="cpu")
    np.testing.assert_allclose(tiled, whole, rtol=0, atol=1e-4)


@pytest.mark.parametrize("tile_w,halo", [(100, 320), (128, 300)])
def test_tile_and_halo_must_be_multiples_of_32(tile_w, halo):
    _, cfg = _configs()
    with pytest.raises(ValueError, match="multiples of 32"):
        tiled_denoise_sequential(cfg, None, _noisy(64), SIGMA,
                                 tile_w=tile_w, halo=halo, device="cpu")


def test_sequential_needs_a_gpu_unless_cpu(monkeypatch):
    """The default device is cuda; with no GPU present it raises (checked
    on every machine: the GPU is hidden)."""
    _, cfg = _configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiled_denoise_sequential(cfg, None, _noisy(64), SIGMA)


def test_reach_derivation_matches_an_empirical_probe():
    """The port's derived reach against a measured jacobian support of the
    port's model (as ``tests/test_tiled.py`` does for the JAX package):
    perturb one column, diff the forward, read off the affected columns.
    Exact at a 32-aligned column on both sides; at the worst alignment the
    analytic 315 dominates the measurement, which exceeds HALO_EXACT - 32."""
    params = bu.init_params(torch.Generator().manual_seed(0), 1, 2, enc=8,
                            dec=16, nin_a=32, nin_b=16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 32, 704, 1)).astype(np.float32))

    @torch.inference_mode()
    def fwd(inp):
        return bu.apply(params, inp, blindspot=True,
                        compute_dtype=torch.float32).numpy()

    base = fwd(x)

    def probe(c0):
        xp = x.clone()
        xp[:, :, c0, :] += 1.0
        d = np.abs(fwd(xp) - base).max(axis=(0, 1, 3))
        nz = np.nonzero(d > 1e-6)[0]
        return c0 - nz.min(), nz.max() - c0

    left, right = probe(352)
    assert right == bu.one_sided_causal_reach(0) == 284
    assert left == bu.one_sided_causal_reach(31) == 285
    _, right = probe(353)
    assert bu.one_sided_causal_reach(1) == bu.one_sided_causal_reach() == 315
    assert HALO_EXACT - 32 < right <= 315


# ---------------------------- evaluation ----------------------------


def _wide_dataset(n=2, w=896, h=32):
    """uint8 images wider than one window (tile_w 128: 7 windows)."""
    rng = np.random.default_rng(5)
    xx = np.arange(w)[None, :, None]
    return [np.clip(127 + 80 * np.sin(xx / (9 + 4 * i))
                    + rng.integers(-20, 20, (h, w, 3)), 0, 255
                    ).astype(np.uint8) for i in range(n)]


def _numpy_injector(dataset, sigma=25.0):
    """add_noise for either package: Gaussian noise from numpy keyed by the
    clean image's index, so both packages score the same noisy images."""
    cleans = [to_internal(im) for im in dataset]

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


def test_evaluate_sequential_matches_full():
    jcfg, cfg = _configs()
    _, params = _weights(jcfg)
    ds = _wide_dataset()
    kw = dict(return_images=2, device="cpu")
    full = evaluate_dataset(cfg, params, ds, **kw)
    seq = evaluate_dataset(cfg, params, ds, mode="sequential",
                           tile_w=TILE_W, halo=HALO_EXACT, **kw)
    np.testing.assert_allclose(seq["psnr_per_image"], full["psnr_per_image"],
                               rtol=0, atol=PSNR_ATOL_DB)
    for a, b in zip(seq["images"], full["images"]):
        np.testing.assert_array_equal(a["noisy"], b["noisy"])
        np.testing.assert_allclose(a["denoised"], b["denoised"], rtol=0,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="multiples of 32"):
        evaluate_dataset(cfg, params, ds, mode="sequential", tile_w=100,
                         device="cpu")


def test_evaluate_sequential_matches_the_jax_package(monkeypatch):
    jcfg, cfg = _configs()
    tree, params = _weights(jcfg)
    ds = _wide_dataset()
    jax_noise, torch_noise = _numpy_injector(ds)
    monkeypatch.setattr(jfull, "add_noise", jax_noise)
    monkeypatch.setattr(tfull, "add_noise", torch_noise)
    theirs = jfull.evaluate_dataset(jcfg, tree, ds, mode="sequential",
                                    tile_w=TILE_W, return_images=2)
    ours = evaluate_dataset(cfg, params, ds, mode="sequential",
                            tile_w=TILE_W, return_images=2, device="cpu")
    np.testing.assert_allclose(ours["psnr_per_image"],
                               theirs["psnr_per_image"], atol=PSNR_ATOL_DB)
    for a, b in zip(ours["images"], theirs["images"]):
        np.testing.assert_allclose(a["denoised"], b["denoised"], **TOL)


# ------------------------------- CLIs -------------------------------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A 2-step tiny workdir from ``cli.train --device cpu``, exported with
    the port's zoo.save, and a folder of two wide noisy PNGs."""
    from ssdn_tpu_torch.cli.train import main as train_main
    from ssdn_tpu_torch.tools.export_pretrained import main as export_main
    from ssdn_tpu_torch.utils import save_image

    root = tmp_path_factory.mktemp("tiledcli")
    wd = root / "wd"
    train_main([
        "--device", "cpu", "--compute-dtype", "float32",
        "--workdir", str(wd), "--train-data", "synthetic:8:64",
        "--iterations", "2", "--batch-size", "2", "--patch-size", "32",
        "--eval-interval", "0", "--snapshot-interval", "2",
        "--log-interval", "0", *TRAIN_TINY,
    ])
    npz = root / "tiny.npz"
    export_main([str(wd), str(npz), "--device", "cpu"])
    indir = root / "in"
    rng = np.random.default_rng(9)
    for i, im in enumerate(_wide_dataset()):
        noisy = np.clip(im / 255.0 + rng.normal(0, 25 / 255, im.shape), 0, 1)
        save_image(str(indir / f"img{i}.png"),
                   (noisy * 255).round().astype(np.uint8))
    return wd, npz, indir


def _captured_denoise(monkeypatch, utils, main, argv):
    """Run a package's cli.denoise ``main``, returning {file name: the
    float image it would have saved} (its ``utils.save_image`` patched)."""
    got = {}
    monkeypatch.setattr(utils, "save_image",
                        lambda path, img: got.__setitem__(
                            path.rsplit("/", 1)[-1], np.asarray(img)))
    main(argv)
    return got


def test_cli_denoise_sequential(exported, tmp_path, monkeypatch):
    """``--tiled sequential --tile-w --halo`` against ``--tiled full`` and
    against the JAX package's CLI on the exported artifact."""
    import ssdn_tpu.utils as jutils
    import ssdn_tpu_torch.utils as tutils
    from ssdn_tpu.cli.denoise import main as jmain
    from ssdn_tpu_torch.cli.denoise import main as tmain

    wd, npz, indir = exported
    common = ["--input", str(indir), "--output", str(tmp_path / "out"),
              "--param", "25"]
    seq = ["--tiled", "sequential", "--tile-w", str(TILE_W), "--halo", "320"]
    ours = _captured_denoise(monkeypatch, tutils, tmain, [
        "--device", "cpu", "--workdir", str(wd), *common, *seq])
    whole = _captured_denoise(monkeypatch, tutils, tmain, [
        "--device", "cpu", "--workdir", str(wd), *common])
    theirs = _captured_denoise(monkeypatch, jutils, jmain, [
        "--pretrained", str(npz), *common, *seq])
    assert sorted(ours) == sorted(whole) == sorted(theirs) == [
        "img0_denoised.png", "img1_denoised.png"]
    for name, img in ours.items():
        assert img.shape == (32, 896, 3)
        np.testing.assert_allclose(img, whole[name], rtol=0, atol=1e-4)
        np.testing.assert_allclose(img, theirs[name], **TOL)
    # --tiled sharded without a launcher: a group of one, the whole image
    sharded = _captured_denoise(monkeypatch, tutils, tmain, [
        "--device", "cpu", "--workdir", str(wd), *common,
        "--tiled", "sharded"])
    assert sorted(sharded) == sorted(whole)
    for name, img in sharded.items():
        np.testing.assert_allclose(img, whole[name], rtol=0, atol=1e-4)


def test_cli_evaluate_sequential(exported, tmp_path, monkeypatch):
    """``cli.evaluate --tiled sequential`` against ``--tiled full`` and
    against the JAX package's CLI on the exported artifact, with the same
    numpy noise on both sides."""
    from ssdn_tpu.cli.evaluate import main as jeval_main
    from ssdn_tpu_torch.cli.evaluate import main as eval_main
    from ssdn_tpu_torch.data import open_dataset

    wd, npz, indir = exported
    jax_noise, torch_noise = _numpy_injector(
        [open_dataset(str(indir))[i] for i in range(2)])
    monkeypatch.setattr(jfull, "add_noise", jax_noise)
    monkeypatch.setattr(tfull, "add_noise", torch_noise)
    seq = ["--tiled", "sequential", "--tile-w", str(TILE_W), "--halo", "320"]
    runs = {}
    for name, main, argv in (
            ("ours", eval_main, ["--device", "cpu", "--workdir", str(wd),
                                 *seq]),
            ("whole", eval_main, ["--device", "cpu", "--workdir", str(wd)]),
            ("theirs", jeval_main, ["--pretrained", str(npz), *seq])):
        out = tmp_path / f"{name}.json"
        main(["--dataset", str(indir), "--json-out", str(out), *argv])
        runs[name] = json.loads(out.read_text())
    for other in ("whole", "theirs"):
        np.testing.assert_allclose(runs["ours"]["psnr_per_image"],
                                   runs[other]["psnr_per_image"], rtol=0,
                                   atol=PSNR_ATOL_DB)
    assert runs["ours"]["n_images"] == 2


def _torchrun(module, argv, world=2):
    """``python -m torch.distributed.run --standalone`` of a port CLI on
    the CPU (one torch thread per rank)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), "-m", module, "--device", "cpu",
         *argv], cwd=root, env=env, capture_output=True, text=True,
        timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout


def test_cli_sharded_and_data_parallel_at_world_size_two(exported, tmp_path):
    """``cli.denoise --tiled sharded`` and ``cli.evaluate --data-parallel``
    / ``--tiled sharded`` under torchrun with 2 CPU ranks, against one
    process's ``--tiled full``: the same PNGs (up to one level: the arrays
    agree to 1e-4, tests/test_torch_sharded.py), the same PSNRs; only rank
    0 prints and writes."""
    from ssdn_tpu_torch.cli.denoise import main as denoise_main
    from ssdn_tpu_torch.cli.evaluate import main as eval_main
    from ssdn_tpu_torch.utils import list_images, load_image

    wd, _, indir = exported
    common = ["--workdir", str(wd), "--input", str(indir), "--param", "25"]
    out = _torchrun("ssdn_tpu_torch.cli.denoise", [
        *common, "--output", str(tmp_path / "sharded"), "--tiled",
        "sharded"])
    assert out.count(" -> ") == 2  # rank 0's lines alone
    denoise_main(["--device", "cpu", *common, "--output",
                  str(tmp_path / "full")])
    names = sorted(os.path.basename(p)
                   for p in list_images(str(tmp_path / "full")))
    assert names == ["img0_denoised.png", "img1_denoised.png"]
    assert sorted(os.path.basename(p) for p in list_images(
        str(tmp_path / "sharded"))) == names
    for name in names:
        a = load_image(str(tmp_path / "sharded" / name)).astype(int)
        b = load_image(str(tmp_path / "full" / name)).astype(int)
        assert np.abs(a - b).max() <= 1, name
    runs = {}
    for name, extra in (("dp", ["--data-parallel"]),
                        ("sharded", ["--tiled", "sharded"])):
        _torchrun("ssdn_tpu_torch.cli.evaluate", [
            "--workdir", str(wd), "--dataset", str(indir), "--json-out",
            str(tmp_path / f"{name}.json"), *extra])
    eval_main(["--device", "cpu", "--workdir", str(wd), "--dataset",
               str(indir), "--json-out", str(tmp_path / "one.json")])
    for name in ("dp", "sharded", "one"):
        runs[name] = json.loads((tmp_path / f"{name}.json").read_text())
    for name in ("dp", "sharded"):
        np.testing.assert_allclose(runs[name]["psnr_per_image"],
                                   runs["one"]["psnr_per_image"],
                                   atol=PSNR_ATOL_DB, err_msg=name)
