"""A copy of the benchmark at a size the CPU runs in seconds: the same
files, with the traffic's corpus, batches and images made small, and the
CPU-side drive of one run (``run.run`` with ``device="cpu"``), which skips
the look for a card."""

from __future__ import annotations

import json
import os
import shutil
from types import SimpleNamespace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _edit(path, **over):
    with open(path) as f:
        d = json.load(f)
    d.update(over)
    with open(path, "w") as f:
        json.dump(d, f)
    return d


def tiny_root(tmp, batch: int = 4) -> str:
    """A checkout root under ``tmp`` holding BENCHMARK.json and a copy of
    the benchmark's folder at CPU size."""
    root = os.path.join(str(tmp), "root")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "h100_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = os.path.join(root, "h100_bench")
    for mix in ("train_b384", "train_b64"):
        _edit(os.path.join(here, "traffic", mix + ".json"),
              batch_size=batch, images=6, image_size=80, warm_steps=1,
              rate_steps=3)
    for name in ("blind_bf16", "ref_fp32"):
        path = os.path.join(here, "configs", name + ".json")
        with open(path) as f:
            c = json.load(f)
        c["train_config"]["batch_size"] = batch
        with open(path, "w") as f:
            json.dump(c, f)
    _edit(os.path.join(here, "traffic", "serve_hd.json"),
          shapes=[[64, 96, 2], [96, 64, 1], [33, 49, 1]], pool=1,
          warm_per_shape=1, sample=3, sample_from=8)
    return root


def run(root: str, workload: str, seed: int = 2 ** 31 + 77, trace: int = 0,
        seconds: float = 1.0):
    """(result line, driver result) of one run on the CPU."""
    import torch

    from h100_bench import run as harness

    torch.set_num_threads(4)
    args = SimpleNamespace(workload=workload, seed=seed, seconds=seconds,
                           trace=trace)
    return harness.run(args, device="cpu", root=root)
