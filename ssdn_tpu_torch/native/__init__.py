"""Native (C++) host-runtime components, loaded via ctypes (the PyTorch
port's own copy of ``ssdn_tpu/native``).

Currently: the multithreaded patch gatherer (``patch_sampler.cpp``, a copy
of the JAX package's source, so its crops are the same bits). It is the
host's crop gatherer, not a device kernel. It compiles on first use with
g++ into ``build/ssdn_tpu_torch/native/`` at the repo root (gitignored,
beside the CUDA builds), keyed by a hash of the source, the machine's
architecture, its C library and the compiler's version, so a library built on another
host is never taken for this one's. Each process
compiles to a temporary name of its own and renames it into place, so
processes that build at once never remove each other's output. With
``backend="auto"`` a failed build falls back to the Python sampler;
``backend="native"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "patch_sampler.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "ssdn_tpu_torch", "native")
_lock = threading.Lock()
_lib = None
_lib_error: Optional[str] = None


def build(out_dir: str = BUILD_DIR) -> str:
    """Compile ``patch_sampler.cpp`` into ``out_dir`` unless its library is
    there already; returns the library's path. Raises on a failed build.
    Safe to call from several processes at once."""
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read())
    compiler = subprocess.run(["g++", "-dumpfullversion"], check=True,
                              capture_output=True).stdout
    host = "\0".join([platform.machine(), *platform.libc_ver()])
    key.update(host.encode() + b"\0" + compiler)
    tag = key.hexdigest()[:16]
    so_path = os.path.join(out_dir, f"_patch_sampler_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
               _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so_path)  # atomic: no reader sees half a file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so_path


def _build_and_load():
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            so_path = build()
        except (OSError, subprocess.CalledProcessError) as e:
            # no compiler / failed build -> the Python sampler
            stderr = getattr(e, "stderr", b"") or b""
            _lib_error = (f"native build failed: {e} "
                          f"{stderr.decode(errors='replace')}").strip()
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            _lib_error = f"native load failed: {e}"
            return None
        lib.sample_patches.argtypes = [
            ctypes.c_void_p,  # arena
            ctypes.c_void_p,  # offsets
            ctypes.c_void_p,  # hw
            ctypes.c_int32,   # n_images
            ctypes.c_int32,   # channels
            ctypes.c_uint64,  # seed
            ctypes.c_uint64,  # step
            ctypes.c_int32,   # batch
            ctypes.c_int32,   # patch
            ctypes.c_void_p,  # out
            ctypes.c_int32,   # n_threads
        ]
        lib.sample_patches.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _build_and_load() is not None


def load_error() -> Optional[str]:
    _build_and_load()
    return _lib_error


class NativePatchSampler:
    """Drop-in alternative to data.PatchSampler backed by the C++ gatherer.

    Builds a contiguous uint8 arena from the dataset once (images smaller
    than the patch are reflect-padded at arena-build time), then sample(step)
    is a single ctypes call. Determinism contract: sample(step) is a pure
    function of (seed, step) — same as the Python sampler, though the two
    backends draw different (both deterministic) crop sequences.
    """

    def __init__(self, dataset, patch_size: int, batch_size: int,
                 seed: int = 0, n_threads: Optional[int] = None):
        lib = _build_and_load()
        if lib is None:
            raise RuntimeError(_lib_error or "native sampler unavailable")
        self._lib = lib
        self.patch = patch_size
        self.batch = batch_size
        self.seed = seed
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        imgs = []
        for i in range(len(dataset)):
            img = dataset[i]
            h, w = img.shape[:2]
            if h < patch_size or w < patch_size:
                img = np.pad(
                    img,
                    [(0, max(0, patch_size - h)), (0, max(0, patch_size - w)),
                     (0, 0)],
                    mode="reflect",
                )
            imgs.append(np.ascontiguousarray(img, dtype=np.uint8))
        self.channels = imgs[0].shape[-1]
        if any(im.shape[-1] != self.channels for im in imgs):
            raise ValueError("mixed channel counts")
        self._hw = np.asarray([im.shape[:2] for im in imgs], np.int32)
        sizes = np.asarray([im.size for im in imgs], np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
            np.int64
        )
        self._arena = np.concatenate([im.reshape(-1) for im in imgs])

    def sample(self, step: int) -> np.ndarray:
        out = np.empty(
            (self.batch, self.patch, self.patch, self.channels), np.uint8
        )
        self._lib.sample_patches(
            self._arena.ctypes.data,
            self._offsets.ctypes.data,
            self._hw.ctypes.data,
            len(self._offsets),
            self.channels,
            ctypes.c_uint64(self.seed),
            ctypes.c_uint64(step),
            self.batch,
            self.patch,
            out.ctypes.data,
            self.n_threads,
        )
        return out


def make_sampler(dataset, patch_size: int, batch_size: int, seed: int = 0,
                 backend: str = "auto"):
    """'native' | 'python' | 'auto' (native when it builds).

    Unbounded streaming datasets always use StreamingPatchSampler (the C++
    arena gatherer requires a materialized finite corpus)."""
    from ssdn_tpu_torch.data.sampler import PatchSampler, StreamingPatchSampler

    if getattr(dataset, "streaming", False):
        return StreamingPatchSampler(dataset, patch_size, batch_size, seed)
    if backend == "python":
        return PatchSampler(dataset, patch_size, batch_size, seed)
    if backend == "native" or (backend == "auto" and available()):
        try:
            return NativePatchSampler(dataset, patch_size, batch_size, seed)
        except Exception:
            if backend == "native":
                raise
    return PatchSampler(dataset, patch_size, batch_size, seed)
