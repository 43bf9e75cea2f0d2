"""The control of every one-card cell, on the card at the cell's own size:
the plain reference put in the program's place one precision below the
configuration's (fp8 for a bf16 trunk, TF32 for float32 with TF32 off) has
to come out not correct against the cell's limits. Run on a card with

    python -m pytest h100_bench/tests/test_h100_bench_control.py -m cuda
"""

from __future__ import annotations

import pytest

from h100_bench import calibrate, check, spec

CELLS = ("blind_bf16.train_b384", "ref_fp32.train_b64",
         "blind_bf16.serve_hd")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    cell = spec.Cell(workload)
    fn = (calibrate.serve_controls if cell.traffic["driver"] == "serve_closed"
          else calibrate.train_controls)
    readings = fn(cell, 4000000021, card)["control"]
    correct, checks = check.judge(readings, cell.limits)
    assert not correct, checks
