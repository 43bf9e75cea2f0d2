"""Runs of the harness on the CPU, past its look for a card, with the timed
path broken underneath: ``correct`` has to come out false for every fault
a cell can have, against the cell's own limits (``limits/``)."""

from __future__ import annotations

import pytest

from h100_bench.tests import faults, tiny

TRAIN = ("blind_bf16.train_b384", "ref_fp32.train_b64")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("faults"), batch=4)


def _run_broken(root, workload, fault):
    undo = fault()
    try:
        line, _ = tiny.run(root, workload)
    finally:
        undo()
    return line


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [faults.state_unchanged, faults.half_batch],
                         ids=lambda f: f.__name__)
def test_training_fault_is_not_correct(root, workload, fault):
    line = _run_broken(root, workload, fault)
    assert line["correct"] is False, line["checks"]


def test_answer_altered_is_not_correct(root):
    line = _run_broken(root, "blind_bf16.serve_hd", faults.answer_altered)
    assert line["correct"] is False, line["checks"]
