"""The numbers that decide ``correct``, and their limits.

Training cells compare the program's first three steps of the timed call
with the plain reference's (``reference/model.py``) from the same seed:

- ``init_gap``: the worst leaf's gap between the norms of the two
  initialisations (an exact comparison, limit 0);
- ``loss_gap``: the largest gap between the two losses over the three
  steps;
- ``grad_gap``: the first step's gradient, as Adam's first moment holds it
  after one step (mu / (1 - b1)), against the reference's: the worst leaf's
  gap between the two norms, over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``change_gap``: the same for the norm of each leaf's change over the
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's, each read over its elements whose
  reference gradient is at least a thousandth of the median leaf's
  root-mean-square element (``moving_elements``). An element whose
  gradient is nought, as in enc6's kernel row that reads only the zero
  padding of a 2x2 map, moves under Adam by round-off alone: eps (1e-8)
  turns a gradient of rounding noise into a step of up to the learning
  rate;
- ``grad_diff``: the norm of the difference of the two first gradients,
  over the same leaves, each over the larger of the reference's norm of
  that leaf and of the median leaf; the worst leaf. A gap of norms cannot
  see a gradient taken over other rows of the batch; this number can.

The serving cell compares a sample of the window's answers, drawn from the
seed, with the reference's denoised images of the same noisy inputs and
weights: ``rms_gap``, the largest root-mean-square gap of one image. The
widest pixel gap is not compared: over a full-HD image its sound readings
reach more than a third of the fp8 control's, so it cannot separate the
two.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Tuple

import numpy as np

MOVING = 1e-3  # a leaf moves when its reference gradient is >= this x median


def _median(d: Dict[str, float]) -> float:
    return float(np.median(np.asarray(list(d.values()))))


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
    med = _median({k: ref[k] for k in keys})
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def _worst(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    return max(_gaps(prog, ref, keys).values())


def moving_elements(g0) -> Dict:
    """{layer: {name: bool tensor}}: the elements of the reference's first
    gradient ``g0`` (a tree of tensors) that are at least ``MOVING`` times
    the median leaf's root-mean-square element."""
    rms = [float(t.double().pow(2).mean().sqrt())
           for leaf in g0.values() for t in leaf.values()]
    floor = MOVING * float(np.median(rms))
    return {n: {k: t.abs() >= floor for k, t in leaf.items()}
            for n, leaf in g0.items()}


def worst_leaves(prog: Dict, ref: Dict) -> Dict[str, str]:
    """The leaf that sets each number of ``training_readings``."""
    leaves = sorted(ref["grad0"])
    med_g = _median(ref["grad0"])
    moving = [k for k in leaves if ref["grad0"][k] >= MOVING * med_g]
    pick = lambda d: max(d, key=d.get)
    diff = {k: prog["grad0_diff"][k] / max(ref["grad0"][k], med_g)
            for k in moving}
    return {"grad_gap": pick(_gaps(prog["grad0"], ref["grad0"], leaves)),
            "change_gap": pick(_gaps(prog["change"], ref["change"], moving)),
            "grad_diff": pick(diff)}


def training_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog and ref: {"init", "grad0", "change": {leaf: norm},
    "loss": [per step]}; prog also {"grad0_diff": {leaf: norm of its first
    gradient less the reference's}}."""
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("the program recorded "
                         f"{len(prog['loss'])} steps, the reference "
                         f"{len(ref['loss'])}")
    leaves = sorted(ref["grad0"])
    med_g = _median(ref["grad0"])
    moving = [k for k in leaves if ref["grad0"][k] >= MOVING * med_g]
    return {
        "init_gap": max(abs(prog["init"][k] - ref["init"][k]) for k in leaves),
        "loss_gap": max(abs(a - b) if math.isfinite(a) else math.inf
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": _worst(prog["grad0"], ref["grad0"], leaves),
        "change_gap": _worst(prog["change"], ref["change"], moving),
        "grad_diff": max(prog["grad0_diff"][k] / max(ref["grad0"][k], med_g)
                         for k in moving),
    }


def image_readings(pairs) -> Dict[str, float]:
    """pairs: (program's image, reference's image) numpy arrays."""
    rms = 0.0
    for got, want in pairs:
        d = got.astype(np.float64) - want.astype(np.float64)
        if not np.all(np.isfinite(d)):
            return {"rms_gap": math.inf}
        rms = max(rms, float(np.sqrt(np.mean(d * d))))
    return {"rms_gap": rms}


def judge(readings: Dict[str, float], limits: Dict) -> Tuple[bool, Dict]:
    """(correct, {name: [reading, limit]}); a number without a reading
    fails."""
    checks, ok = {}, True
    for name, entry in limits["numbers"].items():
        value = readings.get(name, math.inf)
        limit = float(entry["limit"])
        checks[name] = [value, limit]
        ok = ok and value <= limit
    return ok, checks


def print_checks(checks: Dict) -> None:
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
