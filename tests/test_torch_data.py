"""The port's data package (``ssdn_tpu_torch/data``) against the JAX
package's: its own versions of ``tests/test_data.py`` and
``tests/test_streaming.py``, and bit-for-bit equality with the JAX package
for the synthetic images, the datasets, both samplers and the HDF5 round
trip. Both sides are numpy only, so the tolerance is exact equality."""

import numpy as np
import pytest

import ssdn_tpu.data as jdata
from ssdn_tpu.data.tooling import pack_folder as jpack_folder
from ssdn_tpu_torch.data import (
    ArrayDataset,
    FolderDataset,
    HDF5Dataset,
    PatchSampler,
    Prefetcher,
    StreamingPatchSampler,
    StreamingSyntheticDataset,
    make_images,
    open_dataset,
    synthetic_dataset,
    to_grayscale,
)
from ssdn_tpu_torch.data.tooling import pack_folder
from ssdn_tpu_torch.native import make_sampler
from ssdn_tpu_torch.utils import save_image

# ------------------------- bit-for-bit with JAX -------------------------


@pytest.mark.parametrize("n,size,channels,seed", [(3, 64, 3, 7), (2, 48, 1, 0)])
def test_make_images_is_the_jax_packages(n, size, channels, seed):
    for a, b in zip(make_images(n, size, channels, seed),
                    jdata.make_images(n, size, channels, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec,gray", [("synthetic:3:40", False),
                                       ("synthetic:2:32", True)])
def test_open_dataset_synthetic_is_the_jax_packages(spec, gray):
    ours, theirs = open_dataset(spec, grayscale=gray), \
        jdata.open_dataset(spec, grayscale=gray)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours[i], theirs[i])


@pytest.mark.parametrize("gray", [False, True])
def test_streaming_generate_is_the_jax_packages(gray):
    ours = StreamingSyntheticDataset(size=64, seed=4, grayscale=gray)
    theirs = jdata.StreamingSyntheticDataset(size=64, seed=4, grayscale=gray)
    for i in (0, 5, 123456):
        np.testing.assert_array_equal(ours.generate(i), theirs.generate(i))


def test_patch_sampler_is_the_jax_packages():
    ds = synthetic_dataset(n=5, size=48, channels=3, seed=2)
    jds = jdata.synthetic_dataset(n=5, size=48, channels=3, seed=2)
    ours = PatchSampler(ds, patch_size=32, batch_size=6, seed=9)
    theirs = jdata.PatchSampler(jds, patch_size=32, batch_size=6, seed=9)
    for step in (0, 1, 17, 1000):
        np.testing.assert_array_equal(ours.sample(step), theirs.sample(step))


def test_streaming_sampler_is_the_jax_packages():
    ours = StreamingPatchSampler(StreamingSyntheticDataset(size=96), 32, 10,
                                 seed=3)
    theirs = jdata.StreamingPatchSampler(
        jdata.StreamingSyntheticDataset(size=96), 32, 10, seed=3)
    try:
        assert ours.crops_per_image == theirs.crops_per_image
        for step in (0, 1, 11, 500):
            np.testing.assert_array_equal(ours.sample(step),
                                          theirs.sample(step))
    finally:
        ours.close(), theirs.close()


@pytest.mark.parametrize("uniform", [False, True])
def test_hdf5_round_trip_is_the_jax_packages(tmp_path, uniform):
    """Each side packs the same folder; each side reads both files, and all
    four readings are the same images."""
    imgs = make_images(3, size=32, channels=3, seed=1)
    for i, im in enumerate(imgs):
        save_image(str(tmp_path / f"im{i}.png"), im)
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    assert pack_folder(str(tmp_path), ours, uniform=uniform) == 3
    assert jpack_folder(str(tmp_path), theirs, uniform=uniform) == 3
    for path in (ours, theirs):
        a, b = HDF5Dataset(path), jdata.HDF5Dataset(path)
        assert len(a) == len(b) == 3
        for i in range(3):
            np.testing.assert_array_equal(a[i], imgs[i])
            np.testing.assert_array_equal(b[i], imgs[i])


# ----------------- the port's version of tests/test_data.py -----------------


def test_synthetic_images_deterministic():
    a = make_images(3, size=64, channels=3, seed=7)
    b = make_images(3, size=64, channels=3, seed=7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.shape == (64, 64, 3) and x.dtype == np.uint8
    c = make_images(1, size=64, channels=3, seed=8)
    assert np.any(c[0] != a[0])


def test_grayscale_conversion():
    img = np.zeros((4, 4, 3), np.uint8)
    img[..., 0] = 255  # pure red
    g = to_grayscale(img)
    assert g.shape == (4, 4, 1)
    assert abs(int(g[0, 0, 0]) - 76) <= 1  # 0.299 * 255


def test_folder_dataset_roundtrip(tmp_path):
    imgs = make_images(3, size=32, channels=3, seed=0)
    for i, im in enumerate(imgs):
        save_image(str(tmp_path / f"im{i}.png"), im)
    ds = FolderDataset(str(tmp_path))
    assert len(ds) == 3
    np.testing.assert_array_equal(ds[0], imgs[0])
    gds = FolderDataset(str(tmp_path), grayscale=True)
    assert gds[0].shape == (32, 32, 1)


def test_hdf5_pack_and_read(tmp_path):
    imgs = make_images(4, size=32, channels=3, seed=1)
    for i, im in enumerate(imgs):
        save_image(str(tmp_path / f"im{i}.png"), im)
    out = str(tmp_path / "packed.h5")
    n = pack_folder(str(tmp_path), out)
    assert n == 4
    ds = HDF5Dataset(out)
    assert len(ds) == 4
    np.testing.assert_array_equal(ds[2], imgs[2])
    out2 = str(tmp_path / "packed_uniform.h5")
    pack_folder(str(tmp_path), out2, uniform=True)
    ds2 = HDF5Dataset(out2, grayscale=True)
    assert ds2[0].shape == (32, 32, 1)


def test_dataset_tool_cli(tmp_path, capsys):
    from ssdn_tpu_torch.cli.dataset_tool import main

    for i, im in enumerate(make_images(2, size=32, channels=3, seed=5)):
        save_image(str(tmp_path / f"im{i}.png"), im)
    out = str(tmp_path / "packed.h5")
    main(["--input", str(tmp_path), "--output", out])
    assert "packed 2 images" in capsys.readouterr().out
    assert len(open_dataset(out)) == 2


def test_open_dataset_dispatch(tmp_path):
    assert len(open_dataset("synthetic:5:32")) == 5
    with pytest.raises(FileNotFoundError):
        open_dataset(str(tmp_path / "missing"))


def test_bundled_real_photo_dataset():
    from ssdn_tpu_torch.data.datasets import _bundled_photo_paths

    if not _bundled_photo_paths():
        pytest.skip("no bundled sample photos (sklearn/matplotlib missing)")
    ds, jds = open_dataset("bundled"), jdata.open_dataset("bundled")
    assert len(ds) == len(jds) >= 2
    for i in range(len(ds)):
        img = ds[i]
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[-1] == 3
        assert min(img.shape[:2]) >= 256  # real full-size photos, not icons
        np.testing.assert_array_equal(img, jds[i])
    g = open_dataset("bundled", grayscale=True)
    assert g[0].shape[-1] == 1


def test_patch_sampler_determinism_and_bounds():
    ds = synthetic_dataset(n=4, size=48, channels=3, seed=2)
    s = PatchSampler(ds, patch_size=32, batch_size=8, seed=5)
    a, b = s.sample(10), s.sample(10)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (8, 32, 32, 3) and a.dtype == np.uint8
    assert np.any(s.sample(11) != a)


def test_patch_sampler_small_images_padded():
    ds = ArrayDataset([np.full((10, 10, 1), 7, np.uint8)])
    s = PatchSampler(ds, patch_size=32, batch_size=2, seed=0)
    out = s.sample(0)
    assert out.shape == (2, 32, 32, 1)
    assert (out == 7).all()


def test_prefetcher_yields_all_steps_in_order():
    ds = synthetic_dataset(n=2, size=48, channels=3, seed=3)
    s = PatchSampler(ds, patch_size=32, batch_size=2, seed=1)
    got = list(Prefetcher(s, start_step=3, n_steps=4))
    assert len(got) == 4
    np.testing.assert_array_equal(got[0], s.sample(3))
    np.testing.assert_array_equal(got[3], s.sample(6))


def test_prefetcher_multithreaded_order_all_thread_counts():
    # exact step order must hold for every n_threads, including counts
    # that do not divide n_steps (the round-robin sentinel edge case)
    ds = synthetic_dataset(n=2, size=48, channels=3, seed=3)
    s = PatchSampler(ds, patch_size=32, batch_size=2, seed=1)
    want = [s.sample(k) for k in range(5, 5 + 11)]
    for n_threads in (1, 2, 3, 4, 8, 16):
        got = list(Prefetcher(s, start_step=5, n_steps=11, depth=6,
                              n_threads=n_threads))
        assert len(got) == 11, n_threads
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_prefetcher_transform_runs_in_workers():
    ds = synthetic_dataset(n=2, size=48, channels=3, seed=3)
    s = PatchSampler(ds, patch_size=32, batch_size=2, seed=1)
    got = list(Prefetcher(s, 0, 6, n_threads=3,
                          transform=lambda b: b.astype(np.float32) + 1.0))
    assert all(g.dtype == np.float32 for g in got)
    np.testing.assert_array_equal(got[2], s.sample(2).astype(np.float32) + 1)


def test_prefetcher_worker_error_propagates():
    class Boom:
        def sample(self, step):
            if step == 3:
                raise RuntimeError("bad step")
            return np.zeros((1, 2, 2, 1), np.uint8)

    with pytest.raises(RuntimeError, match="bad step"):
        list(Prefetcher(Boom(), 0, 8, n_threads=2))


def test_prefetcher_close_unblocks_workers():
    s = PatchSampler(synthetic_dataset(n=2, size=48, seed=3), 32, 2, seed=1)
    p = Prefetcher(s, 0, 100, depth=4, n_threads=2)
    it = iter(p)
    next(it)
    p.close()  # workers blocked on full queues must exit, not hang
    for t in p.threads:
        t.join(timeout=5.0)
        assert not t.is_alive()


def test_train_cli_config_building():
    from ssdn_tpu_torch.cli.train import build_parser, config_from_args
    from ssdn_tpu_torch.config import NoiseModel, NoiseValue, Pipeline

    args = build_parser().parse_args(
        ["--workdir", "/tmp/x", "--algorithm", "n2n", "--noise-style",
         "poisson30", "--grayscale", "--patch-size", "32",
         "--compute-dtype", "float32"]
    )
    cfg = config_from_args(args)
    assert cfg.pipeline == Pipeline.N2N
    assert cfg.noise.model == NoiseModel.POISSON and cfg.noise.lam == 30
    assert cfg.model.in_channels == 1 and cfg.patch_size == 32
    args2 = build_parser().parse_args(
        ["--workdir", "/tmp/x", "--noise-style", "gauss5_50", "--blind"]
    )
    cfg2 = config_from_args(args2)
    assert cfg2.noise.value == NoiseValue.BLIND
    assert (cfg2.noise.sigma_min, cfg2.noise.sigma_max) == (5, 50)


def test_config_json_roundtrip():
    from ssdn_tpu_torch.config import (
        ModelConfig,
        TrainConfig,
        parse_noise_style,
        to_json,
        train_config_from_json,
    )

    cfg = TrainConfig(
        noise=parse_noise_style("impulse50", blind=True),
        model=ModelConfig(in_channels=1, compute_dtype="float32"),
        patch_size=32,
        grayscale=True,
    )
    cfg2 = train_config_from_json(to_json(cfg))
    assert cfg2 == cfg


# -------------- the port's version of tests/test_streaming.py --------------


def test_open_dataset_inf_spec():
    ds = open_dataset("synthetic:inf:96")
    assert getattr(ds, "streaming", False)
    assert ds.size == 96
    img = ds[123]
    assert img.shape == (96, 96, 3) and img.dtype == np.uint8
    gray = open_dataset("synthetic:inf:64", grayscale=True)
    assert gray[5].shape == (64, 64, 1)


def test_generation_deterministic_and_distinct():
    a = StreamingSyntheticDataset(size=64)
    b = StreamingSyntheticDataset(size=64)
    np.testing.assert_array_equal(a[7], b[7])
    assert not np.array_equal(a[7], a[8])
    np.testing.assert_array_equal(a[7], a[7])


def test_sampler_pure_in_seed_step_and_fresh_across_steps():
    ds = StreamingSyntheticDataset(size=128)
    s1 = StreamingPatchSampler(ds, 64, 8, seed=3)
    s2 = StreamingPatchSampler(ds, 64, 8, seed=3)
    b1, b2 = s1.sample(11), s2.sample(11)
    np.testing.assert_array_equal(b1, b2)
    assert b1.shape == (8, 64, 64, 3)
    b3 = s1.sample(12)
    assert not np.array_equal(b1, b3)
    # freshness: the image indices of steps 11 and 12 don't overlap
    n_imgs = -(-8 // s1.crops_per_image)
    i11 = (11 * n_imgs) % (len(ds) - n_imgs)
    i12 = (12 * n_imgs) % (len(ds) - n_imgs)
    assert set(range(i11, i11 + n_imgs)).isdisjoint(
        range(i12, i12 + n_imgs))
    s1.close(), s2.close()


def test_make_sampler_routes_streaming():
    ds = open_dataset("synthetic:inf:64")
    s = make_sampler(ds, 32, 4, seed=0, backend="auto")
    assert isinstance(s, StreamingPatchSampler)
    assert s.sample(0).shape == (4, 32, 32, 3)
    s.close()


def test_eval_rejects_streaming():
    from ssdn_tpu_torch.config import TrainConfig
    from ssdn_tpu_torch.infer import evaluate_dataset

    ds = open_dataset("synthetic:inf:64")
    with pytest.raises(ValueError, match="finite"):
        evaluate_dataset(TrainConfig(), None, ds)


def test_trainer_rejects_streaming_eval(tmp_path):
    from ssdn_tpu_torch.config import TrainConfig
    from ssdn_tpu_torch.train.loop import Trainer

    with pytest.raises(ValueError, match="streaming"):
        Trainer(TrainConfig(), str(tmp_path),
                train_data="synthetic:inf:64",
                eval_data="synthetic:inf:64", device="cpu")


def test_grayscale_streaming_sampler():
    ds = open_dataset("synthetic:inf:64", grayscale=True)
    s = make_sampler(ds, 32, 4, seed=0)
    b = s.sample(5)
    assert b.shape == (4, 32, 32, 1)
    s.close()


def test_data_package_exports_the_jax_packages_names():
    import ssdn_tpu_torch.data as tdata

    assert set(jdata.__all__) <= set(tdata.__all__)
