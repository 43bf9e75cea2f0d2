"""The harness finds a cell's files by name: a configuration, a traffic mix,
a limits file and a per-layer reader dropped into a copy of the benchmark,
with their entries in BENCHMARK.json, run with no edit to any file that is
there. Names and units outside their alphabets are refused, and the result
line carries exactly the contract's keys."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from h100_bench import spec
from h100_bench.tests import tiny


def add_cell(root):
    here = os.path.join(root, "h100_bench")
    shutil.copy(os.path.join(here, "configs", "ref_fp32.json"),
                os.path.join(here, "configs", "new_cfg.json"))
    shutil.copy(os.path.join(here, "traffic", "train_b64.json"),
                os.path.join(here, "traffic", "new_mix.json"))
    shutil.copy(os.path.join(here, "limits", "ref_fp32.train_b64.json"),
                os.path.join(here, "limits", "new_cfg.new_mix.json"))
    with open(os.path.join(here, "metrics", "new_metric.x.py"), "w") as f:
        f.write("def read(records):\n    return 42.0 + records['steps']\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][1], name="new_cfg",
                                 file="h100_bench/configs/new_cfg.json"))
    bench["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_patches_per_s":
            m["workloads"].append("new_cfg.new_mix")
    bench["per_layer"].append({
        "name": "new_metric.x", "unit": "ms/step", "better": "lower",
        "source": "program_span", "layer": "Train step",
        "moves": "train_patches_per_s", "workloads": ["new_cfg.new_mix"]})
    with open(path, "w") as f:
        json.dump(bench, f)


def test_files_dropped_in_are_found_by_name(tmp_path):
    root = tiny.tiny_root(tmp_path, batch=2)
    before = {os.path.join(dp, p): open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(os.path.join(root, "h100_bench"))
              for p in fs if not p.endswith(".pyc")}
    add_cell(root)
    cell = spec.Cell("new_cfg.new_mix", root)
    assert cell.driver_name == "trainer"
    assert [m["name"] for m in cell.per_layer][-1] == "new_metric.x"
    line, _ = tiny.run(root, "new_cfg.new_mix", trace=1)
    assert line["metrics"]["new_metric.x"]["value"] > 42.0
    assert line["metrics"]["new_metric.x"]["unit"] == "ms/step"
    for path, content in before.items():
        assert open(path, "rb").read() == content, path


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", ".a", "", "x" * 65,
                                  "café", "a\tb"])
def test_bad_names_are_refused(name):
    with pytest.raises(spec.SpecError):
        spec.check_name("metric", name)


@pytest.mark.parametrize("name", ["a", "_x", "9.b-c", "x" * 64,
                                  "blind_bf16.train_b384"])
def test_good_names_pass(name):
    assert spec.check_name("metric", name) == name


@pytest.mark.parametrize("unit, ok", [
    ("patches/s", True), ("%", True), ("ms/batch", True), ("GiB", True),
    ("patches per s", False), ("µs", False), ("x" * 17, False),
    ("", False), ("a,b", False)])
def test_units(unit, ok):
    if ok:
        assert spec.check_unit(unit) == unit
    else:
        with pytest.raises(spec.SpecError):
            spec.check_unit(unit)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(tmp_path, trace):
    """The driver reads correct, attempted, failed, metrics and device (and
    breakdown when traced); ``checks``, each number beside its limit,
    comes last."""
    root = tiny.tiny_root(tmp_path, batch=2)
    line, _ = tiny.run(root, "ref_fp32.train_b64", trace=trace)
    keys = list(line)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[:5] == want and keys[-1] == "checks"
    assert set(keys) == set(want) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU runs no K3 kernel: its reader reads nothing
        assert set(line["metrics"]) == {"sampler_ms.train", "step_mfu.train",
                                        "device_idle.train"}
    else:
        assert set(line["metrics"]) == {"train_patches_per_s",
                                        "peak_device_gib", "setup_s"}
    assert all(len(v) == 2 for v in line["checks"].values())
    json.dumps(line)
