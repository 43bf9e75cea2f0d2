"""The yardstick's counts (``counts.py``) checked by hand, and the shares
read from a synthetic trace kept at or under 100%."""

from __future__ import annotations

import importlib.util
import math
import os

import pytest

from h100_bench import counts, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METRICS = os.path.join(ROOT, "h100_bench", "metrics")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_one_conv_layer():
    # enc1 at 64x64: 2 * 4096 pixels * 9 taps * 48 * 48
    assert counts.conv_flops(64, 64, 48, 48) == 2 * 4096 * 9 * 48 * 48


@pytest.mark.parametrize("blind, n_out", [(True, 10), (False, 9)])
def test_head_per_pixel(blind, n_out):
    assert counts.n_outputs(blind) == n_out
    assert counts.head_flops_per_pixel(n_out) == 2 * (384 * 384 + 384 * 96
                                                      + 96 * n_out)


def test_forward_of_a_patch():
    """10.24 GFLOP per 64x64 patch: four trunks of 532,210.5 FLOP per
    input pixel (literal decoder) plus the head."""
    per_px = (2592 + 41472 + 10368 + 2592 + 648 + 162 + 40.5    # encoder
              + 648 + 648 + 3888 + 2592 + 15552 + 10368        # dec5..3
              + 62208 + 41472 + 171072 + 165888)               # dec2..1
    want = 4096 * (4 * per_px + counts.head_flops_per_pixel(10))
    assert counts.forward_flops(64, 64, True) == pytest.approx(want, rel=1e-12)
    assert counts.forward_flops(64, 64, True) == pytest.approx(10.24e9,
                                                               rel=1e-3)


def test_forward_of_a_kodak_request():
    assert counts.forward_flops(512, 768, True) == pytest.approx(0.983e12,
                                                                 rel=1e-3)
    assert counts.step_flops(384, 64, True) == pytest.approx(11.79e12,
                                                             rel=1e-3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_head_kernels_match_chip_smoke(dtype):
    """K2 / K2' / K3 counts equal chip_smoke.py's at one shape."""
    import chip_smoke
    import torch

    dt = getattr(torch, dtype)
    m, nc = 4096, 10
    xs = [torch.empty((m, 96), dtype=dt) for _ in range(4)]
    was = [torch.empty((96, 384), dtype=dt) for _ in range(4)]
    wb, wc = torch.empty((384, 96), dtype=dt), torch.empty((96, nc), dtype=dt)
    h1 = torch.empty((m, 384), dtype=dt)
    for save in (False, True):
        nbytes, ops = counts.k2_cost(m, dtype, nc, save_h1=save)
        want = chip_smoke.k2_cost(torch, xs, was, wb, wc, save_h1=save)
        assert want[0] == pytest.approx(
            counts.bound_s(nbytes, ops, dtype) * 1e3, rel=1e-12)
    nbytes, ops = counts.k3_cost(m, dtype, nc)
    want = chip_smoke.k3_cost(torch, xs, was, h1, wb, wc)
    assert want[0] == pytest.approx(counts.bound_s(nbytes, ops, dtype) * 1e3,
                                    rel=1e-12)


def _train_records(k3_s_per_step, steps=10, busy=0.5, window=11.0):
    m = 384 * 64 * 64
    least = counts.bound_s(*counts.k3_cost(m, "bfloat16", 10), "bfloat16")
    ns = math.ceil(least * k3_s_per_step * 1e9)
    dev = [((i + 1) * 10 ** 9, (i + 1) * 10 ** 9 + ns,
            "void wgrad_tc_kernel<4>(TcGradArgs)") for i in range(steps)]
    dev.append((0, int(busy * 1e9), "sm90_xmma_gemm_bf16"))
    t = trace.reduce_trace(dev, [], window)
    return {"kind": "train", "steps": steps, "rows_per_card": 384,
            "patch": 64, "blind": True, "dtype": "bfloat16",
            "wall_s": window, "trace": t, "traces": [t],
            "sampler_spans": [0.002]}


@pytest.mark.parametrize("slower", [1.0, 1.7, 40.0])
def test_shares_stay_at_or_under_100(slower):
    """A K3 that takes exactly its least time reads 100%; slower, less. The
    idle share and the MFU of the same synthetic trace lie in (0, 100]."""
    rec = _train_records(slower)
    k3 = reader("k3_roofline.train").read(rec)
    assert k3 == pytest.approx(100.0 / slower, rel=1e-6) and k3 <= 100.0 + 1e-6
    idle = reader("device_idle.train").read(rec)
    assert 0 < idle <= 100
    assert 0 < reader("step_mfu.train").read(rec) <= 100


def test_a_reader_with_nothing_to_read_reports_nothing():
    from h100_bench.metrics_base import NothingToRead

    rec = _train_records(1.0)
    rec["trace"] = dict(rec["trace"], kernel_s={})
    with pytest.raises(NothingToRead):
        reader("k3_roofline.train").read(rec)
    with pytest.raises(NothingToRead):
        reader("k2_roofline.serve").read(rec)
