#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ssdn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Run from the root of the repository on a machine with an NVIDIA H100 (any
``sm_90a`` card) and the CUDA toolkit. It imports no JAX. Phases, each of
which fails the run (non-zero exit) on any error:

1. prints the card (``nvidia-smi`` name and power limit) and torch's
   version, and turns TF32 off so that fp32 means true fp32;
2. builds the CUDA kernels K1 and K2 from ``ssdn_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch twin on the card: on the
   operands of real 768x512 requests (every K1 layer shape, K2 at
   M = 393,216, fp32 and bf16 models) and at random shapes (Cin 1, a
   ragged M);
4. the main path: two bundled pretrained models (``gauss25_rgb`` in fp32,
   ``gauss5_50_blind_rgb`` in bf16) serve 5 requests each — four Kodak-size
   768x512 images and one BSD68-size 481x321 — through ``make_denoise_fn``
   / ``denoise_image``, in each of the three backend arms (torch ops; the
   head kernel K2; the conv kernel K1). Every arm must agree with the
   torch-ops arm, beat the noisy PSNR by 3 dB, and launch its kernel the
   expected number of times; the card's fp32 run must match the port's
   CPU run (which the test suite holds against the JAX package);
5. times each arm per 768x512 request, and each kernel per request
   against its bound, its twin and a library yardstick.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU it exits with code 2 and
prints no result. ``--report`` writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, dense) for the bounds
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor bf16; fp32 FMA
PEAK_BYTES = 3.35e12
KODAK = (512, 768)   # H, W of a landscape Kodak image
BSD68 = (321, 481)   # H, W of a landscape BSD68 image (pads to 352x512)
MODELS = ("gauss25_rgb", "gauss5_50_blind_rgb")
ARMS = {"lax": ("lax", "lax"), "head_pallas": ("lax", "pallas"),
        "conv_pallas": ("pallas", "lax")}
K1_PER_TRUNK = 12    # enc0-enc6 and dec5b-dec1b; dec*a stay on torch ops


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    run = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return run.stdout.strip().splitlines()[0]


# ------------------------------ images ------------------------------


def smooth_field(rng, h, w, c):
    """Sum of bilinearly upsampled noise octaves, scaled to [0, 1]."""
    acc = np.zeros((h, w, c), np.float32)
    amp, res = 1.0, 4
    while res <= max(h, w):
        coarse = rng.standard_normal((res, res, c)).astype(np.float32)
        yi, xi = np.linspace(0, res - 1, h), np.linspace(0, res - 1, w)
        y0, x0 = np.floor(yi).astype(int), np.floor(xi).astype(int)
        y1, x1 = np.minimum(y0 + 1, res - 1), np.minimum(x0 + 1, res - 1)
        ty = (yi - y0).astype(np.float32)[:, None, None]
        tx = (xi - x0).astype(np.float32)[None, :, None]
        rows = coarse[y0] * (1 - ty) + coarse[y1] * ty
        acc += amp * (rows[:, x0] * (1 - tx) + rows[:, x1] * tx)
        amp, res = amp * 0.55, res * 2
    return (acc - acc.min()) / (np.ptp(acc) + 1e-6)


def clean_image(seed, h, w):
    """A smooth field plus a few flat rectangles and disks, internal range."""
    rng = np.random.default_rng(seed)
    img = smooth_field(rng, h, w, 3)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(5):
        color = rng.uniform(0, 1, 3).astype(np.float32)
        r0, c0 = rng.integers(0, h), rng.integers(0, w)
        if rng.uniform() < 0.5:
            mask = ((yy >= r0) & (yy < r0 + h // 4)
                    & (xx >= c0) & (xx < c0 + w // 4))
        else:
            mask = (yy - r0) ** 2 + (xx - c0) ** 2 < (min(h, w) // 6) ** 2
        img[mask] = 0.3 * img[mask] + 0.7 * color
    return np.clip(img, 0, 1).astype(np.float32) - 0.5


@functools.lru_cache(maxsize=None)
def _requests(sigma_min, sigma_max):
    sigmas = np.linspace(max(sigma_min, min(15.0, sigma_max)), sigma_max, 5)
    out = []
    for i, hw in enumerate([KODAK] * 4 + [BSD68]):
        clean = clean_image(100 + i, *hw)
        noisy = clean + np.random.default_rng(200 + i).normal(
            0, sigmas[i] / 255, clean.shape).astype(np.float32)
        out.append((clean, noisy, float(sigmas[i])))
    return out


def requests(cfg):
    """(clean, noisy, sigma_255) for the 5 requests: 4 Kodak-size, 1
    BSD68-size, with Gaussian noise at the model's own sigma (the one value
    of a known-sigma model; a blind model's trained range from 15 up)."""
    return _requests(cfg.noise.sigma_min, cfg.noise.sigma_max)


def sigma_vec(sigma):
    return np.full((1,), sigma / 255, np.float32)


# ------------------------------ helpers ------------------------------


def cuda_ms(torch, fn, reps):
    """Mean device time of fn over reps launches (CUDA events), warmed."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, dtype_name):
    """(least ms, "bytes" | "operations") on the published peaks."""
    tb = nbytes / PEAK_BYTES * 1e3
    to = ops / PEAK_OPS[dtype_name] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def dname(torch, dt):
    return {torch.bfloat16: "bfloat16", torch.float32: "float32"}[dt]


def k1_cost(torch, x, w):
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    es = x.element_size()
    nbytes = x.numel() * es + w.numel() * es + cout * 4 + n * cout * h * wd * es
    return bound(nbytes, 2 * n * h * wd * 9 * cin * cout, dname(torch, x.dtype))


def k2_cost(torch, xs, was, wb, wc):
    m, c = xs[0].shape
    es = xs[0].element_size()
    na, nb, nc = was[0].shape[1], wb.shape[1], wc.shape[1]
    nbytes = (len(xs) * m * c * es + (len(xs) * c * na + na * nb + nb * nc) * es
              + (na + nb + nc) * 4 + m * nc * 4)
    ops = 2 * m * (len(xs) * c * na + na * nb + nb * nc)
    return bound(nbytes, ops, dname(torch, xs[0].dtype))


def k1_error(torch, got, ref):
    """(max abs err, max rel err, ok). fp32: 1e-4 of the output's range.
    bf16: within 2 bf16 ulps of the twin's value (one rounding of an fp32
    sum on each side; the sums differ only in order), with 1e-5 of the
    range as the floor near zero."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    scale = r.abs().max().clamp_min(1e-30)
    if got.dtype == torch.float32:
        ok = bool((d <= 1e-4 * scale).all())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2 ** -126))) - 7)
        ok = bool((d <= 2 * ulp + 1e-5 * scale).all())
    return d.max().item(), (d.max() / scale).item(), ok


def k2_error(got, ref, bf16):
    """(max abs err, max rel err, ok). The output is fp32 either way. fp32:
    1e-4 of the range. bf16: h1 and h2 are rounded to bf16 on both sides,
    so one flipped rounding (2**-8) can move the output; bar 2**-6 of the
    range (the CPU tests' bar)."""
    d = (got - ref).abs()
    scale = ref.abs().max().clamp_min(1e-30)
    tol = 2 ** -6 if bf16 else 1e-4
    return d.max().item(), (d.max() / scale).item(), bool((d <= tol * scale).all())


# ------------------------------ phases ------------------------------


def load_model(name, device):
    from ssdn_tpu_torch import zoo
    from ssdn_tpu_torch.models.blindspot_unet import params_from_jax

    cfg, tree, _ = zoo.load(name)
    return cfg, params_from_jax(tree, device=device)


def with_arm(cfg, arm):
    conv, head = ARMS[arm]
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, conv_backend=conv, head_backend=head))


def capture_operands(torch, models, report):
    """Operands of every kernel call of one 768x512 request per model,
    recorded by wrapping the kernels where the model calls them."""
    from ssdn_tpu_torch.infer import full
    from ssdn_tpu_torch.models import blindspot_unet as bu

    k1, k2 = bu.shifted_conv3x3_bias_act, bu.fused_nin_head
    calls = {}

    def recorder(key, fn):
        def wrapped(*args, **kwargs):
            calls[key].append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    try:
        for name, (cfg, params) in models.items():
            _, noisy, sigma = requests(cfg)[0]
            calls[("k1", name)], calls[("k2", name)] = [], []
            bu.shifted_conv3x3_bias_act = recorder(("k1", name), k1)
            bu.fused_nin_head = recorder(("k2", name), k2)
            for arm in ("conv_pallas", "head_pallas"):
                full.denoise_image(
                    full.make_denoise_fn(with_arm(cfg, arm)), params, noisy,
                    sigma_vec(sigma))
    finally:
        bu.shifted_conv3x3_bias_act, bu.fused_nin_head = k1, k2
    torch.cuda.synchronize()
    for key, c in calls.items():
        check(len(c) == (2 * K1_PER_TRUNK if key[0] == "k1" else 1),
              f"captured {len(c)} calls of {key}")
    report["captured"] = {f"{k}:{n}": len(c) for (k, n), c in calls.items()}
    return calls


def kernels_vs_twins(torch, calls, report):
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    rows = []
    for (kind, model), cs in calls.items():
        for i, (args, kwargs) in enumerate(cs):
            if kind == "k1":
                x, w, b = args
                got = K1.shifted_conv3x3_bias_act(x, w, b, **kwargs)
                ref = K1.torch_reference(x, w, b, **kwargs)
                err = k1_error(torch, got, ref)
                shape = f"{tuple(x.shape)}->{w.shape[0]}"
                dt = x.dtype
            else:
                got = K2.fused_nin_head(*args)
                ref = K2.torch_reference(*args)
                err = k2_error(got, ref, args[0][0].dtype == torch.bfloat16)
                shape = f"M={args[0][0].shape[0]} k={len(args[0])} n_out={args[5].shape[1]}"
                dt = args[0][0].dtype
            rows.append(dict(kernel=kind, model=model, call=i, shape=shape,
                             dtype=dname(torch, dt), max_abs_err=err[0],
                             max_rel_err=err[1], ok=err[2]))
    # random operands at shapes the two models above do not reach: the
    # grayscale enc0 (Cin 1) and ragged M / odd n_out for the head
    g = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 1, 512, 768, device="cuda", generator=g).to(dt)
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randn(48, 1, 3, 3, device="cuda", generator=g) * 0.3
        b = torch.randn(48, device="cuda", generator=g) * 0.1
        err = k1_error(torch, K1.shifted_conv3x3_bias_act(x, w, b),
                       K1.torch_reference(x, w, b))
        rows.append(dict(kernel="k1", model="random", call=0,
                         shape="(2, 1, 512, 768)->48", dtype=dname(torch, dt),
                         max_abs_err=err[0], max_rel_err=err[1], ok=err[2]))
        for m, k, nc in ((393216 - 17, 4, 10), (1000, 1, 2)):
            xs = [(torch.randn(m, 96, device="cuda", generator=g) * 0.5).to(dt)
                  for _ in range(k)]
            was = [(torch.randn(96, 384, device="cuda", generator=g) * 0.05
                    ).to(dt) for _ in range(k)]
            rest = [torch.randn(384, device="cuda", generator=g) * 0.1,
                    (torch.randn(384, 96, device="cuda", generator=g) * 0.05
                     ).to(dt),
                    torch.randn(96, device="cuda", generator=g) * 0.1,
                    (torch.randn(96, nc, device="cuda", generator=g) * 0.1
                     ).to(dt),
                    torch.randn(nc, device="cuda", generator=g) * 0.1]
            err = k2_error(K2.fused_nin_head(xs, was, *rest),
                           K2.torch_reference(xs, was, *rest),
                           dt == torch.bfloat16)
            rows.append(dict(kernel="k2", model="random", call=0,
                             shape=f"M={m} k={k} n_out={nc}",
                             dtype=dname(torch, dt), max_abs_err=err[0],
                             max_rel_err=err[1], ok=err[2]))
    torch.cuda.synchronize()
    report["kernel_vs_twin"] = rows
    for r in rows:
        print(f"  {r['kernel']} {r['model']:<20} {r['shape']:<28} {r['dtype']:<8} "
              f"max_abs {r['max_abs_err']:.3e} max_rel {r['max_rel_err']:.3e} "
              f"{'ok' if r['ok'] else 'FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"{len(bad)} kernel-vs-twin comparisons out of tolerance")
    return rows


def serve(torch, models, report):
    """The main path: 5 requests per model in each arm, kernel counts read
    just around it. Returns {(model, arm): [denoised images]}."""
    from ssdn_tpu_torch.infer import full
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1
    from ssdn_tpu_torch.utils.images import psnr

    reqs = {name: requests(cfg) for name, (cfg, _) in models.items()}
    fns = {(name, arm): full.make_denoise_fn(with_arm(cfg, arm))
           for name, (cfg, _) in models.items() for arm in ARMS}
    out, per_arm = {}, {}
    K1.launches = K2.launches = 0
    for (name, arm), fn in fns.items():
        k1_0, k2_0 = K1.launches, K2.launches
        params = models[name][1]
        out[name, arm] = [full.denoise_image(fn, params, y, sigma_vec(s))
                          for _, y, s in reqs[name]]
        per_arm[name, arm] = (K1.launches - k1_0, K2.launches - k2_0)
    launches = {"k1": K1.launches, "k2": K2.launches}
    report["main_path_launches"] = launches
    print(f"  main path launches: K1 {launches['k1']}, K2 {launches['k2']}")

    for (name, arm), (k1n, k2n) in per_arm.items():
        n = len(reqs[name])
        want = {"lax": (0, 0), "head_pallas": (0, n),
                "conv_pallas": (2 * K1_PER_TRUNK * n, 0)}[arm]
        check((k1n, k2n) == want,
              f"{name}/{arm}: launches K1 {k1n}, K2 {k2n}, expected {want}")
    rows = []
    for name, (cfg, _) in models.items():
        # fp32: both arms true fp32, only summation order differs; bf16: the
        # kernels round once where cuDNN's conv rounds before the bias add,
        # and one-ulp (2**-8) differences compound through 17 layers
        tol = 1e-4 if cfg.model.compute_dtype == "float32" else 4 / 255
        for arm in ARMS:
            for i, ((clean, y, s), den) in enumerate(
                    zip(reqs[name], out[name, arm])):
                check(den.shape == clean.shape and np.isfinite(den).all(),
                      f"{name}/{arm} request {i}: shape {den.shape}")
                diff = float(np.abs(den - out[name, "lax"][i]).max())
                gain = psnr(den, clean) - psnr(y, clean)
                rows.append(dict(model=name, arm=arm, request=i,
                                 size=f"{clean.shape[1]}x{clean.shape[0]}",
                                 sigma=s, psnr_gain_db=gain,
                                 max_abs_diff_vs_lax=diff, tol=tol))
                check(diff <= tol, f"{name}/{arm} request {i}: differs from "
                                   f"the lax arm by {diff:.3e} > {tol:.1e}")
                check(gain >= 3.0, f"{name}/{arm} request {i}: PSNR gain "
                                   f"{gain:.2f} dB < 3")
    report["requests"] = rows
    for r in rows:
        print(f"  {r['model']:<20} {r['arm']:<12} req {r['request']} "
              f"{r['size']:<8} sigma {r['sigma']:4.0f}  gain "
              f"{r['psnr_gain_db']:6.2f} dB  |arm - lax| "
              f"{r['max_abs_diff_vs_lax']:.2e}")
    return launches


def gpu_vs_cpu(torch, report):
    """The card against the port's CPU run on a small input (fp32
    gauss25_rgb, every arm vs the CPU torch-ops arm, 1e-4)."""
    from ssdn_tpu_torch.infer import full

    cfg, params_gpu = load_model("gauss25_rgb", "cuda")
    _, params_cpu = load_model("gauss25_rgb", "cpu")
    clean = clean_image(7, 64, 96)
    y = clean + np.random.default_rng(8).normal(
        0, 25 / 255, clean.shape).astype(np.float32)
    pv = sigma_vec(25.0)
    ref = full.denoise_image(full.make_denoise_fn(cfg, device="cpu"),
                             params_cpu, y, pv)
    diffs = {}
    for arm in ARMS:
        got = full.denoise_image(full.make_denoise_fn(with_arm(cfg, arm)),
                                 params_gpu, y, pv)
        diffs[arm] = float(np.abs(got - ref).max())
    report["gpu_vs_cpu_max_abs"] = diffs
    print(f"  card vs CPU (fp32, 96x64): {diffs}")
    check(all(d <= 1e-4 for d in diffs.values()),
          f"card and CPU disagree: {diffs}")


def time_requests(torch, models, report, reps=5):
    from ssdn_tpu_torch.infer import full

    rows = []
    for name, (cfg, params) in models.items():
        _, y, s = requests(cfg)[0]
        pv = sigma_vec(s)
        for arm in ARMS:
            fn = full.make_denoise_fn(with_arm(cfg, arm))
            for _ in range(2):
                full.denoise_image(fn, params, y, pv)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(reps):
                full.denoise_image(fn, params, y, pv)  # ends in a host copy
            ms = (time.perf_counter() - t0) / reps * 1e3
            rows.append(dict(model=name, dtype=cfg.model.compute_dtype,
                             arm=arm, ms_per_request=ms,
                             mp_per_s=KODAK[0] * KODAK[1] / 1e6 / (ms / 1e3),
                             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    report["request_timing"] = rows
    for r in rows:
        print(f"  {r['model']:<20} {r['dtype']:<8} {r['arm']:<12} "
              f"{r['ms_per_request']:8.2f} ms/request  {r['mp_per_s']:6.2f} MP/s"
              f"  peak {r['peak_mem_gb']:.2f} GB")
    return rows


def profile_request(torch, models, report):
    """Device busy time, by kernel name, of one 768x512 request per arm,
    and the device's idle share of the unprofiled request time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ssdn_tpu_torch.infer import full

    wall = {(r["model"], r["arm"]): r["ms_per_request"]
            for r in report["request_timing"]}
    out = {}
    for name, (cfg, params) in models.items():
        _, y, s = requests(cfg)[0]
        pv = sigma_vec(s)
        for arm in ARMS:
            fn = full.make_denoise_fn(with_arm(cfg, arm))
            full.denoise_image(fn, params, y, pv)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                full.denoise_image(fn, params, y, pv)
                torch.cuda.synchronize()
            # device-side events only (kernels, copies): one stream, so
            # their sum is the busy time
            evs = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            evs.sort(key=lambda e: -e.self_device_time_total)
            busy = sum(e.self_device_time_total for e in evs) / 1e3
            top = [(e.key.replace("void (anonymous namespace)::", "")[:60],
                    e.self_device_time_total / 1e3, e.count) for e in evs[:8]]
            idle = 1 - busy / wall[name, arm]
            out[f"{name}/{arm}"] = dict(device_busy_ms=busy, idle_share=idle,
                                        top=top)
            print(f"  {name:<20} {arm:<12} device busy {busy:6.2f} ms, idle "
                  f"{idle:5.1%}: " + ", ".join(f"{k[:32]} {ms:.2f}"
                                               for k, ms, _ in top[:3]))
    report["profile"] = out


def time_kernels(torch, calls, launches, report, reps=10):
    """Per-request kernel time (sum over one request's calls) against the
    bound, the twin, and a library yardstick (timed only, never used)."""
    import torch.nn.functional as F

    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    def k1_library(x, w, b, negative_slope=0.1):
        # one cuDNN conv on the unpadded input (symmetric pad 2 rows, its
        # first H rows are the causal-up conv) + LeakyReLU
        y = F.conv2d(x, w.to(x.dtype), b.to(x.dtype), padding=(2, 1))
        return F.leaky_relu(y[:, :, :x.shape[2]], negative_slope)

    def k2_library(xs, was, ba, wb, bb, wc, bc):
        x = torch.cat([F.leaky_relu(t, 0.1) for t in xs], 1)
        h1 = F.leaky_relu(torch.addmm(ba.to(x.dtype), x, torch.cat(was)), 0.1)
        h2 = F.leaky_relu(torch.addmm(bb.to(x.dtype), h1, wb), 0.1)
        return torch.addmm(bc, h2.float(), wc.float())

    kernels = {
        "k1": ("shifted_conv3x3_bias_act", "ssdn_tpu_torch/csrc/shifted_conv.cu",
               "ssdn_tpu/ops/pallas/shifted_conv.py:80",
               K1.shifted_conv3x3_bias_act, K1.torch_reference, k1_library),
        "k2": ("fused_nin_head", "ssdn_tpu_torch/csrc/nin_head.cu",
               "ssdn_tpu/ops/pallas/nin_head.py:107",
               K2.fused_nin_head, K2.torch_reference, k2_library),
    }
    per = {}
    for (kind, model), cs in calls.items():
        name, source, replaces, kern, twin, lib = kernels[kind]
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   t_bytes=0.0, t_ops=0.0, launches_per_request=len(cs))
        layers = []
        for args, kwargs in cs:
            row = {f: cuda_ms(torch, lambda f=f: fn(*args, **kwargs), reps)
                   for f, fn in (("ms", kern), ("plain_ms", twin),
                                 ("library_ms", lib))}
            if kind == "k1":
                b_ms, by = k1_cost(torch, args[0], args[1])
                row["shape"] = f"{tuple(args[0].shape)}->{args[1].shape[0]}"
            else:
                b_ms, by = k2_cost(torch, args[0], args[1], args[3], args[5])
                row["shape"] = f"M={args[0][0].shape[0]} k={len(args[0])}"
            row.update(bound_ms=b_ms, bound_by=by)
            layers.append(row)
            for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[f] += row[f]
            tot["t_ops" if by == "operations" else "t_bytes"] += b_ms
        tot["bound_by"] = "operations" if tot["t_ops"] >= tot["t_bytes"] else "bytes"
        tot["dtype"] = dname(
            torch, (cs[0][0][0] if kind == "k1" else cs[0][0][0][0]).dtype)
        per[kind, model] = dict(tot, layers=layers)
        print(f"  {name} {model:<20} {tot['dtype']:<8} per request: "
              f"{tot['ms']:.3f} ms (bound {tot['bound_ms']:.3f} ms, "
              f"{tot['bound_by']}), twin {tot['plain_ms']:.3f} ms, "
              f"library {tot['library_ms']:.3f} ms, "
              f"{tot['launches_per_request']} launches")
    report["kernel_timing"] = {f"{k}:{m}": v for (k, m), v in per.items()}

    errs = report["kernel_vs_twin"]
    line = []
    for kind, (name, source, replaces, *_rest) in kernels.items():
        # the flagship's bf16 model is the headline; fp32 is in the report
        model = next(m for (k, m), v in per.items()
                     if k == kind and v["dtype"] == "bfloat16")
        v = per[kind, model]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[kind],
            max_abs_err=max(r["max_abs_err"] for r in errs
                            if r["kernel"] == kind and r["model"] == model),
            ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
            bound_by=v["bound_by"], library_ms=v["library_ms"],
            per="one 768x512 request", dtype=v["dtype"], model=model))
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--report", default=None,
                   help="write every measurement to this JSON file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from ssdn_tpu_torch.kernels import _build

    report = {}
    print("[1] card")
    card = card_line()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report["card"] = card

    print("[2] build")
    t0 = time.perf_counter()
    logs = _build.build()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = logs
    print(f"  built {sorted(logs) or 'nothing (cached)'} in "
          f"{report['build_s']:.1f} s")

    print("[3] kernels vs twins")
    models = {name: load_model(name, "cuda") for name in MODELS}
    calls = capture_operands(torch, models, report)
    kernels_vs_twins(torch, calls, report)

    print("[4] main path: 5 requests x 3 arms x 2 models")
    launches = serve(torch, models, report)
    check(launches["k1"] > 0 and launches["k2"] > 0,
          f"a kernel was not launched on the main path: {launches}")
    gpu_vs_cpu(torch, report)

    print("[5] timing")
    time_requests(torch, models, report)
    profile_request(torch, models, report)
    kernel_line = time_kernels(torch, calls, launches, report)

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(card)
    print(json.dumps({"kernels": kernel_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
