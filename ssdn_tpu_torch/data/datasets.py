"""Clean-image datasets (the PyTorch port's own copy of
``ssdn_tpu/data/datasets.py``; numpy only, so every image is the JAX
package's, bit for bit).

Reference equivalents: ``UnlabelledImageFolderDataset`` -> FolderDataset,
``HDF5Dataset`` -> HDF5Dataset [R]. The reference's ``NoiseWrappedDataset``
and ``FixedLengthSampler`` have no classes here by design: noise injection
moved on-device into the jitted step (noise/), and fixed-length step-indexed
sampling is the sampler's native semantics (sampler.py).

Protocol: len(ds) and ds[i] -> uint8 HWC numpy array (C = 1 or 3).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ssdn_tpu_torch.data.synthetic import make_images
from ssdn_tpu_torch.utils.images import list_images, load_image


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> uint8 HW1 (ITU-R BT.601 luma)."""
    if img.shape[-1] == 1:
        return img
    luma = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return np.clip(luma + 0.5, 0, 255).astype(np.uint8)[..., None]


class FolderDataset:
    """Folder of image files, loaded lazily with a small LRU-ish cache."""

    def __init__(self, folder: str, grayscale: bool = False,
                 cache_all: bool = True):
        self.paths = list_images(folder)
        if not self.paths:
            raise FileNotFoundError(f"no images in {folder}")
        self.grayscale = grayscale
        self._cache: Optional[List[Optional[np.ndarray]]] = (
            [None] * len(self.paths) if cache_all else None
        )

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        if self._cache is not None and self._cache[i] is not None:
            return self._cache[i]
        img = load_image(self.paths[i], grayscale=self.grayscale)
        if self._cache is not None:
            self._cache[i] = img
        return img


class HDF5Dataset:
    """Pre-packed uint8 images in an HDF5 file (see tooling.pack_folder).

    Layout: either one dataset ``images`` of shape (N, H, W, C), or N
    datasets ``images/<i>`` for variable-size corpora.
    """

    def __init__(self, path: str, grayscale: bool = False):
        import h5py  # lazy: only HDF5 corpora need it

        self._f = h5py.File(path, "r")
        self.grayscale = grayscale
        obj = self._f["images"]
        self._group = isinstance(obj, h5py.Group)
        if self._group:  # group of per-image datasets (variable sizes)
            self._keys = sorted(obj.keys(), key=int)
            self._n = len(self._keys)
        else:  # one (N, H, W, C) dataset
            self._n = obj.shape[0]

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> np.ndarray:
        if self._group:
            img = np.asarray(self._f["images"][self._keys[i]], np.uint8)
        else:
            img = np.asarray(self._f["images"][i], np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        return to_grayscale(img) if self.grayscale else img


class ArrayDataset:
    """In-memory list of uint8 HWC arrays (synthetic corpora, tests)."""

    def __init__(self, images: Sequence[np.ndarray], grayscale: bool = False):
        self.images = list(images)
        self.grayscale = grayscale

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> np.ndarray:
        img = self.images[i]
        return to_grayscale(img) if self.grayscale else img


def synthetic_dataset(
    n: int = 64, size: int = 128, channels: int = 3, seed: int = 0,
    grayscale: bool = False,
) -> ArrayDataset:
    return ArrayDataset(
        make_images(n, size=size, channels=channels, seed=seed),
        grayscale=grayscale and channels == 3,
    )


class StreamingSyntheticDataset:
    """Unbounded procedural corpus: image i is generated on demand,
    deterministically in (seed, i) — no two training steps ever have to
    reuse an image, which removes the memorization confound of the finite
    synthetic corpora (VERDICT r2 item 3). Spec: ``synthetic:inf[:size]``.

    Indexable like every other dataset (len = a 2^31-sized virtual epoch;
    a tiny LRU covers repeated reads), but samplers should prefer
    ``StreamingPatchSampler`` (sampler.py), which amortizes generation
    over several crops per fresh image and parallelizes it.
    """

    streaming = True
    VIRTUAL_LEN = 2 ** 31 - 1

    def __init__(self, size: int = 128, channels: int = 3, seed: int = 0,
                 grayscale: bool = False, cache: int = 256):
        self.size = size
        self.channels = channels
        self.seed = seed
        self.grayscale = grayscale
        self._cache: "dict[int, np.ndarray]" = {}
        self._cache_max = cache
        # spectral-field generator state, precomputed once: a radial
        # frequency grid for the 1/f^alpha filter and coordinate grids for
        # the shape painter. FFT-filtered noise gives the same "smooth
        # field + sharp shapes" structure as the octave generator in
        # synthetic.py, whose fancy indexing is too slow to feed a
        # training step with fresh images.
        fy = np.fft.fftfreq(size)[:, None]
        fx = np.fft.rfftfreq(size)[None, :]
        self._freq = np.sqrt(fy * fy + fx * fx)
        self._freq[0, 0] = 1.0 / size
        self._yy, self._xx = np.mgrid[0:size, 0:size]

    def __len__(self) -> int:
        return self.VIRTUAL_LEN

    def generate(self, i: int) -> np.ndarray:
        """Uncached deterministic generation of image i (thread-safe)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0x5712EA3, i])
        )
        size, c = self.size, self.channels
        alpha = rng.uniform(0.9, 1.6)  # spectral slope: texture variety
        white = rng.standard_normal((c, size, size)).astype(np.float32)
        spec = np.fft.rfft2(white) * (self._freq ** -alpha)
        img = np.fft.irfft2(spec, s=(size, size)).transpose(1, 2, 0)
        lo, hi = img.min(), img.max()
        img = (img - lo) / (hi - lo + 1e-6)
        # sharp-edged shapes (denoising needs edges): rectangles by slice
        # assignment, disks via the precomputed coordinate grid
        for _ in range(int(rng.integers(2, 6))):
            color = rng.uniform(0, 1, c).astype(np.float32)
            blend = rng.uniform(0.5, 1.0)
            if rng.uniform() < 0.5:
                r0, c0 = rng.integers(0, size, 2)
                h, w = rng.integers(size // 8, size // 2, 2)
                reg = img[r0 : r0 + h, c0 : c0 + w]
                reg *= 1 - blend
                reg += blend * color
            else:
                cy, cx = rng.integers(0, size, 2)
                rad = int(rng.integers(size // 10, size // 3))
                mask = ((self._yy - cy) ** 2 + (self._xx - cx) ** 2
                        < rad * rad)
                img[mask] = (1 - blend) * img[mask] + blend * color
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        return to_grayscale(img) if self.grayscale else img

    def __getitem__(self, i: int) -> np.ndarray:
        img = self._cache.get(i)
        if img is None:
            img = self.generate(i)
            if len(self._cache) >= self._cache_max:
                self._cache.pop(next(iter(self._cache)))
            self._cache[i] = img
        return img


def _bundled_photo_paths() -> List[str]:
    """Real photographs shipped inside installed packages: sklearn's sample
    images (china.jpg, flower.jpg, 640x427 RGB) and matplotlib's
    grace_hopper.jpg (512x600 RGB). Both packages are optional."""
    paths: List[str] = []
    try:
        import sklearn.datasets as skd

        d = os.path.join(os.path.dirname(skd.__file__), "images")
        paths += [os.path.join(d, f) for f in ("china.jpg", "flower.jpg")]
    except ImportError:
        pass
    try:
        import matplotlib

        paths.append(os.path.join(matplotlib.get_data_path(), "sample_data",
                                  "grace_hopper.jpg"))
    except ImportError:
        pass
    return [p for p in paths if os.path.isfile(p)]


def bundled_dataset(grayscale: bool = False) -> ArrayDataset:
    """Eval set of real photographs found on disk (spec: ``bundled``).

    The reference evaluates on Kodak/BSD68/Set14; where those are not on
    disk, this is the closest real-photo PSNR anchor (3 images).
    Generalization check: models trained on the procedural streaming
    corpus are scored on photographs they could never have seen.
    """
    paths = _bundled_photo_paths()
    if not paths:
        raise FileNotFoundError(
            "no bundled sample photos found (sklearn/matplotlib missing?)"
        )
    return ArrayDataset([load_image(p) for p in paths], grayscale=grayscale)


def open_dataset(spec: str, grayscale: bool = False):
    """Open a dataset from a path spec: an image folder, an .h5/.hdf5 file,
    'synthetic[:n[:size]]' for the finite procedural corpus,
    'synthetic:inf[:size]' for the unbounded streaming one, or 'bundled'
    for the real-photo eval set shipped inside installed packages."""
    if spec == "bundled":
        return bundled_dataset(grayscale=grayscale)
    if spec.startswith("synthetic"):
        parts = spec.split(":")
        if len(parts) > 1 and parts[1] in ("inf", "stream"):
            size = int(parts[2]) if len(parts) > 2 else 128
            return StreamingSyntheticDataset(size=size, grayscale=grayscale)
        n = int(parts[1]) if len(parts) > 1 else 64
        size = int(parts[2]) if len(parts) > 2 else 128
        ds = synthetic_dataset(n=n, size=size, channels=3)
        ds.grayscale = grayscale
        return ds
    if spec.endswith((".h5", ".hdf5")):
        return HDF5Dataset(spec, grayscale=grayscale)
    if os.path.isdir(spec):
        return FolderDataset(spec, grayscale=grayscale)
    raise FileNotFoundError(spec)
