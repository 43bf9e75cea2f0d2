"""The port's native C++ patch gatherer (``ssdn_tpu_torch/native``): its
version of ``tests/test_native.py``'s crop, determinism, padding and
backend tests, bit-for-bit equality with the JAX package's
``NativePatchSampler`` for the same (seed, step), and several processes
building the library at once. Both gatherers are the same C++ code, so the
tolerance is exact equality. There is no wall-clock race here."""

import os
import subprocess
import sys

import numpy as np
import pytest

import ssdn_tpu.native as jnative
from ssdn_tpu.data import synthetic_dataset as jsynthetic_dataset
from ssdn_tpu_torch import native
from ssdn_tpu_torch.data import ArrayDataset, PatchSampler, synthetic_dataset
from ssdn_tpu_torch.native import NativePatchSampler, make_sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK = (1 << 64) - 1


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        pytest.fail(f"the port's native sampler did not build: "
                    f"{native.load_error()}")


def splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK
    return x ^ (x >> 31)


def expected_indices(seed, step, j, n_images, hw, ps):
    s = splitmix64(seed ^ splitmix64(step ^ splitmix64(j)))
    r1 = splitmix64(s)
    r2 = splitmix64(r1)
    r3 = splitmix64(r2)
    img = r1 % n_images
    h, w = hw[img]
    return img, r2 % (h - ps + 1), r3 % (w - ps + 1)


def test_crops_match_python_mirror():
    ds = synthetic_dataset(n=5, size=48, channels=3, seed=0)
    s = NativePatchSampler(ds, patch_size=16, batch_size=32, seed=9)
    out = s.sample(3)
    hw = [(ds[i].shape[0], ds[i].shape[1]) for i in range(5)]
    for j in range(32):
        img, r, c = expected_indices(9, 3, j, 5, hw, 16)
        np.testing.assert_array_equal(
            out[j], ds[img][r : r + 16, c : c + 16],
            err_msg=f"sample {j} (img {img} @ {r},{c})",
        )


def test_determinism_and_step_variation():
    ds = synthetic_dataset(n=3, size=64, channels=1, seed=1)
    s = NativePatchSampler(ds, patch_size=32, batch_size=8, seed=4)
    np.testing.assert_array_equal(s.sample(7), s.sample(7))
    assert np.any(s.sample(8) != s.sample(7))


def test_small_images_padded():
    ds = ArrayDataset([np.full((10, 12, 3), 5, np.uint8)])
    s = NativePatchSampler(ds, patch_size=32, batch_size=4, seed=0)
    out = s.sample(0)
    assert out.shape == (4, 32, 32, 3)
    assert (out == 5).all()


def test_make_sampler_backends():
    ds = synthetic_dataset(n=2, size=48, channels=3, seed=2)
    assert isinstance(make_sampler(ds, 32, 4, backend="python"), PatchSampler)
    assert isinstance(
        make_sampler(ds, 32, 4, backend="native"), NativePatchSampler
    )
    auto = make_sampler(ds, 32, 4, backend="auto")
    assert isinstance(auto, NativePatchSampler)


def test_native_backend_raises_when_the_build_fails(monkeypatch):
    """'native' refuses to fall back; 'auto' falls back to Python."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", "native build failed: no g++")
    ds = synthetic_dataset(n=2, size=48, channels=3, seed=2)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        make_sampler(ds, 32, 4, backend="native")
    assert isinstance(make_sampler(ds, 32, 4, backend="auto"), PatchSampler)


def test_sample_is_the_jax_packages(monkeypatch, tmp_path):
    """The JAX package's sampler, built by its own code from its own source
    into a private directory (so no other test process races its build),
    gives the port's bits at every (seed, step)."""
    monkeypatch.setattr(jnative, "_DIR", str(tmp_path))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_error", None)
    assert jnative.available(), jnative.load_error()
    for size, channels, patch, batch in ((48, 3, 16, 32), (64, 1, 32, 9),
                                         (40, 3, 64, 4)):
        ds = synthetic_dataset(n=5, size=size, channels=channels, seed=1)
        jds = jsynthetic_dataset(n=5, size=size, channels=channels, seed=1)
        for seed in (0, 9, 2 ** 40 + 3):
            ours = NativePatchSampler(ds, patch, batch, seed=seed)
            theirs = jnative.NativePatchSampler(jds, patch, batch, seed=seed)
            for step in (0, 1, 123, 2 ** 33):
                np.testing.assert_array_equal(
                    ours.sample(step), theirs.sample(step),
                    err_msg=f"size {size} seed {seed} step {step}")


def test_processes_building_at_once_all_succeed(tmp_path):
    """Four processes build into one empty directory at once: each compiles
    to a temporary name of its own, so every one ends with the library
    (the reference's shared temporary name lost the race)."""
    code = ("import sys; from ssdn_tpu_torch import native; "
            "print(native.build(sys.argv[1]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    (path,) = paths
    assert os.path.exists(path)
    assert [n for n in os.listdir(tmp_path) if n.endswith(".tmp")] == []


def test_library_name_depends_on_the_host(monkeypatch, tmp_path):
    """The library's name hashes the host's architecture and compiler with
    the source: a library built on another machine and copied here in
    ``build/`` is not taken for this one's, this host builds its own."""
    ours = native.build(str(tmp_path))
    assert native.build(str(tmp_path)) == ours
    monkeypatch.setattr(native.platform, "machine", lambda: "other-arch")
    theirs = native.build(str(tmp_path))
    assert theirs != ours
    assert os.path.exists(theirs) and os.path.exists(ours)
