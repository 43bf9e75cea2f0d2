"""Import hygiene of the PyTorch port: no module of ``ssdn_tpu_torch`` and
not ``chip_smoke.py`` nor a probe (``k1_probe.py``, ``k2_probe.py``,
``k3_probe.py``) imports JAX (or jaxlib, flax, optax) or anything of the
JAX package ``ssdn_tpu``, and importing the port builds no kernel."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ssdn_tpu")


def _port_files():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "k1_probe.py",
                                                   "k2_probe.py", "k3_probe.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ssdn_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_exist():
    files = _port_files()
    assert os.path.exists(files[0]), "chip_smoke.py is missing"
    assert len(files) > 15


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_ssdn_tpu_import(path):
    bad = [f"{os.path.relpath(path, REPO)}:{line}: import {mod}"
           for line, mod in _imported_roots(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_importing_the_port_builds_nothing_and_loads_no_jax():
    code = (
        "import sys\n"
        "import ssdn_tpu_torch, ssdn_tpu_torch.cli.denoise, "
        "ssdn_tpu_torch.infer, ssdn_tpu_torch.models, ssdn_tpu_torch.zoo\n"
        "import ssdn_tpu_torch.kernels.shifted_conv, "
        "ssdn_tpu_torch.kernels.nin_head, ssdn_tpu_torch.noise, "
        "ssdn_tpu_torch.train, ssdn_tpu_torch.train.step, "
        "ssdn_tpu_torch.estimator.core\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} or m == 'ssdn_tpu_torch.kernels._build']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
