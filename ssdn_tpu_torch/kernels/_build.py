"""Build the port's CUDA kernels from ``ssdn_tpu_torch/csrc/*.cu`` and load
them with ctypes.

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds) under
``build/ssdn_tpu_torch/`` at the repo root, keyed by a hash of the source,
the headers in ``csrc/`` and the flags; ``build`` starts one ``nvcc`` per missing library, all at
once. Nothing here runs at import time: the kernel wrappers call ``load``
on their first CUDA launch, and CPU code paths never reach this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ssdn_tpu_torch")
SOURCES = ("shifted_conv", "nin_head", "nin_head_bwd", "conv_epilogue")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    """(source, library path). The library's name carries a hash of the
    source, of every header in ``csrc/`` (a source may include any of
    them) and of the flags, so an edited header never loads a stale
    library."""
    src = os.path.join(CSRC, name + ".cu")
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC, n) for n in headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns {name: compiler output} for
    the sources compiled now (``-Xptxas=-v``: registers, shared memory,
    spills), also kept beside each library (``build_log``). Raises with
    the compiler output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _paths(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out.decode(errors="replace")
        if proc.returncode:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                          f"{logs[name]}")
        else:
            with open(lib + ".log", "w") as f:
                f.write(logs[name])
            os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """The compiler output of ``csrc/<name>.cu``'s current library (built
    now if missing)."""
    build([name])
    with open(_paths(name)[1] + ".log") as f:
        return f.read()


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` set from ``signatures`` and every function returning the
    launch's ``cudaError_t`` as an int."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_paths(name)[1])
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib
