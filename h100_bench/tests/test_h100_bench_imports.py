"""What the benchmark may load and read.

- A fresh interpreter that imports ``run.py``, every driver, every metric
  reader, the reference and every module of the port that the drivers
  import holds no ``jax``, ``jaxlib``, ``flax`` or ``ssdn_tpu`` (top-level
  names compared whole, so ``ssdn_tpu_torch`` passes).
- No file of the benchmark imports them, and the reference imports nothing
  of the port.
- No file of the benchmark reads the JAX package's benchmark: root
  ``bench.py``, ``tools/``, ``BENCH_*`` or ``MULTICHIP_*``.
- The card-only tests decide in a fixture, never at import.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from h100_bench import guard

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN_READS = ("bench.py", "tools/", "BENCH_", "MULTICHIP_")


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


PROBE = r"""
import glob, importlib.util, json, os, sys
sys.path.insert(0, {root!r})
import h100_bench.run, h100_bench.calibrate
from h100_bench import spec
from h100_bench.reference import model
for kind in ("drivers", "metrics"):
    for p in sorted(glob.glob(os.path.join({bench!r}, kind, "*.py"))):
        spec.load_module(p, os.path.basename(p))
import ssdn_tpu_torch.train.loop, ssdn_tpu_torch.infer.full
import ssdn_tpu_torch.native, ssdn_tpu_torch.data
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, bench=BENCH)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert "ssdn_tpu_torch" in {n.split(".")[0] for n in names}
    assert guard.jax_modules(names) == []


@pytest.mark.parametrize("names, found", [
    (["ssdn_tpu_torch", "ssdn_tpu_torch.train"], []),
    (["ssdn_tpu.models", "torch"], ["ssdn_tpu"]),
    (["jax._src.core"], ["jax"]),
    (["jaxlib", "flax.linen"], ["flax", "jaxlib"]),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert guard.jax_modules(names) == found


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_file_imports_jax_or_reads_the_jax_benchmark(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & guard.FORBIDDEN, path
    with open(path) as f:
        text = f.read()
    if os.path.basename(path) != os.path.basename(__file__):
        assert not [s for s in FORBIDDEN_READS if s in text], path


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch"}, tops


def test_benchmark_names_no_file_outside_its_folder():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["paths"] == ["h100_bench"]
    for word in bench["command"][1:]:
        assert word.startswith("h100_bench/") and ".." not in word
    for c in bench["configs"]:
        assert c["file"].startswith("h100_bench/")
