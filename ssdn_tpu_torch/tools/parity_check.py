"""Parity measurement (port of ``tools/parity_check.py``): the stabilized
default arm (bf16, Huber+bounds+beta-NLL) against the TRUE
reference-objective arm (``--objective reference``: raw NLL, unbounded
outputs, beta=0, Adam eps 1e-8, fp32) on identical data and seeds. Both
arms train through ``cli.train.main``, then the PSNR-vs-step table is
printed.

Usage:
  python -m ssdn_tpu_torch.tools.parity_check [steps] [train_spec] \\
      [eval_spec] [--device cuda|cpu] [--workroot DIR] [cli.train flags]

Defaults: 3000 synthetic:64 synthetic:8, on the GPU; pass e.g. ``10000
synthetic:inf:256 synthetic:8`` for the non-memorizable streaming corpus.
Each arm's workdir is ``WORKROOT/parity_<arm>`` (default: the system's
temporary directory), emptied first. Flags this tool does not know go to
both arms' ``cli.train`` after its own (so ``--batch-size 8`` or
``--enc-features 8`` override them).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

ARMS = {
    "stabilized_bf16": [],
    "reference_objective": ["--objective", "reference"],
}


def main(argv=None) -> dict:
    """Trains both arms; returns {arm: {step: eval PSNR}}."""
    from ssdn_tpu_torch.cli.train import main as train_main

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("steps", nargs="?", type=int, default=3000)
    p.add_argument("train", nargs="?", default="synthetic:64")
    p.add_argument("eval", nargs="?", default="synthetic:8")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where both arms train (default: the GPU)")
    p.add_argument("--workroot", default=tempfile.gettempdir(),
                   help="directory for the two arms' workdirs")
    args, extra = p.parse_known_args(argv)
    every = max(args.steps // 40, 250)

    table = {}
    for name, arm in ARMS.items():
        wd = os.path.join(args.workroot, f"parity_{name}")
        shutil.rmtree(wd, ignore_errors=True)
        print(f"=== arm {name} ===", flush=True)
        train_main([
            "--workdir", wd, "--train-data", args.train,
            "--eval-data", args.eval, "--iterations", str(args.steps),
            "--batch-size", "64", "--eval-interval", str(every),
            "--snapshot-interval", str(args.steps),
            "--log-interval", str(every), "--seed", "0",
            "--device", args.device,
        ] + arm + extra)
        evals = {}
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("prefix") == "eval" and "psnr" in rec:
                    evals[rec["step"]] = rec["psnr"]
        table[name] = evals
        print(name, evals, flush=True)

    steps = sorted({s for e in table.values() for s in e})
    print("\n| step | " + " | ".join(table) + " |", flush=True)
    for s in steps:
        row = " | ".join(f"{table[a].get(s, float('nan')):.3f}"
                         for a in table)
        print(f"| {s} | {row} |", flush=True)
    return table


if __name__ == "__main__":
    main()
