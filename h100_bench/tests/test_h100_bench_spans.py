"""The readers of the port's spans (``"source": "program_span"``): a tiny
traced CPU run of the bf16 training and serving cells reports their
metrics, an untraced run reports none, and a port that records no spans
leaves them out without failing the run."""

from __future__ import annotations

import pytest

from h100_bench.tests import tiny

TRAIN = {"batch_wait_ms.train", "to_device_ms.train", "fixed_ms.train"}
SERVE = {"pad_ms.serve", "dispatch_ms.serve"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("spans"), batch=2)


def test_traced_training_run_reports_the_trainer_spans(root):
    line, _ = tiny.run(root, "blind_bf16.train_b384", trace=1)
    got = {k: v["value"] for k, v in line["metrics"].items() if k in TRAIN}
    # the CPU run copies nothing to a device: to_device_ms reads nothing
    assert set(got) == TRAIN - {"to_device_ms.train"}
    assert all(v > 0 for v in got.values()), got
    assert line["metrics"]["fixed_ms.train"]["unit"] == "ms/call"
    assert line["correct"] is True, line["checks"]


def test_traced_serving_run_reports_the_request_spans(root):
    line, _ = tiny.run(root, "blind_bf16.serve_hd", trace=1)
    got = {k: v["value"] for k, v in line["metrics"].items() if k in SERVE}
    assert set(got) == SERVE
    assert all(v > 0 for v in got.values()), got
    assert line["metrics"]["pad_ms.serve"]["unit"] == "ms/request"
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("workload", ["blind_bf16.train_b384",
                                      "blind_bf16.serve_hd"])
def test_untraced_run_reports_none_of_them(root, workload):
    line, _ = tiny.run(root, workload, trace=0)
    assert not set(line["metrics"]) & (TRAIN | SERVE)


def test_the_fp32_cell_does_not_read_them(root):
    line, _ = tiny.run(root, "ref_fp32.train_b64", trace=1)
    assert not set(line["metrics"]) & (TRAIN | SERVE)


def test_a_port_without_spans_reads_nothing(root, monkeypatch):
    from ssdn_tpu_torch.utils import debug

    for name in ("spans", "totals"):
        monkeypatch.delattr(debug, name)
    line, _ = tiny.run(root, "blind_bf16.serve_hd", trace=1)
    assert "request_mfu.serve" in line["metrics"]
    assert not set(line["metrics"]) & SERVE
