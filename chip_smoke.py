#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ssdn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Run from the root of the repository on a machine with an NVIDIA H100 (any
``sm_90a`` card) and the CUDA toolkit. It imports no JAX. Phases, each of
which fails the run (non-zero exit) on any error:

1. prints the card (``nvidia-smi`` name and power limit) and torch's
   version, and turns TF32 off so that fp32 means true fp32;
2. builds the CUDA kernels K1, K2/K2' and K3 from ``ssdn_tpu_torch/csrc``
   with nvcc, one process per source, all at once;
3. holds each kernel against its plain PyTorch twin on the card: K1 and K2
   on the operands of real 768x512 requests (every K1 layer shape, K2 at
   M = 393,216), K2' and K3 on the operands of a real batch-384 training
   step (M = 1,572,864, k 4; K2' and K3 launched twice and compared bit
   for bit, K2' against K2's out bits), K1 at the training shapes, and
   random ragged shapes and narrow widths (K2 / K2' and K3 in both dtypes
   at M 1 to 4,133 and C/Na/Nb 40/72/24, K2 / K2' also 16/32/16, fp32 K2 /
   K2' and K3 also at Na 512, C 3 and 99, Nb 200 / Nc 40 and K3 at 16/32/16;
   bf16 K1 at Cin 1, 3, 97, 99, 144, W 2, 4, 7 and BSD68's 512x352; K3 and
   bf16 K1 each launched twice and compared bit for bit);
   then times K2', K3 and K1 (bf16 and fp32, from each model's step)
   per training step against their bounds, twins and library yardsticks;
4. the serving path: two bundled pretrained models (``gauss25_rgb`` in
   fp32, ``gauss5_50_blind_rgb`` in bf16) serve 5 requests each — four
   Kodak-size 768x512 images and one BSD68-size 481x321 — through
   ``make_denoise_fn`` / ``denoise_image``, in each of the three backend
   arms (torch ops; the head kernel K2; the conv kernel K1). Every arm must
   agree with the torch-ops arm, beat the noisy PSNR by 3 dB, and launch
   its kernel the expected number of times; the card's fp32 run must match
   the port's CPU run (which the test suite holds against the JAX package);
5. the training path: from the same pretrained weights, one batch-384 step
   (64x64 crops of smooth synthetic images) of each kernel arm against the
   torch-ops arm (fp32 and bf16; K2' / K3 launch once and K1 12 times in
   each kernel arm's step 0, counted around it) and the card's step
   against the port's CPU step (32x32); then 30 steps of the bf16 model
   in each arm through ``make_train_step`` (uint8 batch, noise on the
   card, forward, backward, Adam): finite, the loss falls, and K1 / K2' /
   K3 launch 12 / 1 / 1 times per step in their arms; then the reference
   objective's fp32 training step (``gauss25_rgb``, batch 384) timed over
   10 steps in the lax and head arms (K2' / K3 fp32 once per step);
6. times each arm per 768x512 request and per training step (patches/s),
   profiles one request and one step per arm (device busy and idle share),
   and each kernel per request against its bound, its twin and a library
   yardstick (the kernels line: the bf16 model's numbers, the fp32 model's
   under ``per_request_fp32`` / ``per_train_step_fp32``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU it exits with code 2 and
prints no result. ``--report`` writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
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
DEVICE = "cuda"
K1_PER_TRUNK = 12    # enc0-enc6 and dec5b-dec1b; dec*a stay on torch ops
TRAIN_BATCH = 384    # the flagship training batch (bench.py's headline)
PATCH = 64           # training patch side
TRAIN_STEPS = 30     # steps per arm on the training path
TRAIN_WARM = 5       # steps before the patches/s clock starts
# the reference objective's fp32 training step (gauss25_rgb): timed steps
# after warm-ups, per arm
REF_ARMS = ("lax", "head_pallas")
REF_STEPS, REF_WARM = 10, 3


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


def k2_cost(torch, xs, was, wb, wc, save_h1=False):
    m, c = xs[0].shape
    es = xs[0].element_size()
    na, nb, nc = was[0].shape[1], wb.shape[1], wc.shape[1]
    nbytes = (len(xs) * m * c * es + (len(xs) * c * na + na * nb + nb * nc) * es
              + (na + nb + nc) * 4 + m * nc * 4 + (m * na * es if save_h1 else 0))
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


def fp32_error(got, ref, rtol=1e-5):
    """(max abs err, max rel err, ok): fp32 within 1e-5 + rtol |ref| of the
    twin (summation order only; the card tests' bars: out rtol 0, h1 rtol
    1e-5)."""
    d = (got - ref).abs()
    scale = ref.abs().max().clamp_min(1e-30)
    ok = bool((d <= 1e-5 + rtol * ref.abs()).all())
    return d.max().item(), (d.max() / scale).item(), ok


def k1_library(x, w, b, negative_slope=0.1):
    """K1's library yardstick: one cuDNN conv on the unpadded input
    (symmetric pad 2 rows; its first H rows are the causal-up conv) +
    LeakyReLU. Timed only, never used by the port."""
    import torch.nn.functional as F

    y = F.conv2d(x, w.to(x.dtype), b.to(x.dtype), padding=(2, 1))
    return F.leaky_relu(y[:, :, :x.shape[2]], negative_slope)


def head_library(xs, was, ba, wb, bb, wc, bc):
    """The fused head's library yardstick: three ``addmm`` (cuBLAS). Timed
    only, never used by the port."""
    import torch
    import torch.nn.functional as F

    x = torch.cat([F.leaky_relu(t, 0.1) for t in xs], 1)
    h1 = F.leaky_relu(torch.addmm(ba.to(x.dtype), x, torch.cat(was)), 0.1)
    h2 = F.leaky_relu(torch.addmm(bb.to(x.dtype), h1, wb), 0.1)
    return torch.addmm(bc, h2.float(), wc.float())


def device_profile(torch, fn):
    """(device busy ms, top kernels as (name, ms, count)) of one call of fn,
    from torch.profiler's device-side events (kernels, copies): one
    stream, so their sum is the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    evs.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    top = [(e.key.replace("void (anonymous namespace)::", "")[:60],
            e.self_device_time_total / 1e3, e.count) for e in evs[:10]]
    return busy, top


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


def _detached(a):
    if isinstance(a, (list, tuple)):
        return type(a)(_detached(t) for t in a)
    return a.detach() if hasattr(a, "detach") else a


def recorder(calls, key, fn, when=lambda *a, **k: True):
    """fn, recording the arguments of each call (that ``when`` accepts)
    under calls[key], detached from any autograd graph."""
    def wrapped(*args, **kwargs):
        if when(*args, **kwargs):
            calls.setdefault(key, []).append((_detached(args), kwargs))
        return fn(*args, **kwargs)
    return wrapped


def capture_operands(torch, models, report):
    """Operands of every kernel call of one 768x512 request per model,
    recorded by wrapping the kernel wrappers where the model reaches them."""
    from ssdn_tpu_torch.infer import full
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    k1, k2 = K1.shifted_conv3x3_bias_act, K2.fused_nin_head
    calls = {}
    try:
        for name, (cfg, params) in models.items():
            _, noisy, sigma = requests(cfg)[0]
            K1.shifted_conv3x3_bias_act = recorder(calls, ("k1", name), k1)
            K2.fused_nin_head = recorder(calls, ("k2", name), k2)
            for arm in ("conv_pallas", "head_pallas"):
                full.denoise_image(
                    full.make_denoise_fn(with_arm(cfg, arm)), params, noisy,
                    sigma_vec(sigma))
    finally:
        K1.shifted_conv3x3_bias_act, K2.fused_nin_head = k1, k2
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
    g = torch.Generator(device=DEVICE).manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 1, 512, 768, device=DEVICE, generator=g).to(dt)
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randn(48, 1, 3, 3, device=DEVICE, generator=g) * 0.3
        b = torch.randn(48, device=DEVICE, generator=g) * 0.1
        err = k1_error(torch, K1.shifted_conv3x3_bias_act(x, w, b),
                       K1.torch_reference(x, w, b))
        rows.append(dict(kernel="k1", model="random", call=0,
                         shape="(2, 1, 512, 768)->48", dtype=dname(torch, dt),
                         max_abs_err=err[0], max_rel_err=err[1], ok=err[2]))
        for m, k, nc in ((393216 - 17, 4, 10), (1000, 1, 2)):
            xs, was, rest = random_head(torch, g, m, k, nc, dt)
            err = k2_error(K2.fused_nin_head(xs, was, *rest),
                           K2.torch_reference(xs, was, *rest),
                           dt == torch.bfloat16)
            rows.append(dict(kernel="k2", model="random", call=0,
                             shape=f"M={m} k={k} n_out={nc}",
                             dtype=dname(torch, dt), max_abs_err=err[0],
                             max_rel_err=err[1], ok=err[2]))
    rows += k1_bf16_rows(torch, g)
    # bf16 on the tensor cores: ragged row tiles and narrow widths (the
    # generic instantiation); each launched twice (same bits) and beside
    # K2' (the same kernel: the same out bits)
    for m, k, nc, widths in K2_BF16_CASES:
        xs, was, rest = random_head(torch, g, m, k, nc, torch.bfloat16,
                                    **widths)
        got = K2.fused_nin_head(xs, was, *rest)
        again = K2.fused_nin_head(xs, was, *rest)
        with_h1 = K2.nin_head_fwd(xs, was, *rest, save_h1=True)[0]
        same = torch.equal(got, again) and torch.equal(got, with_h1)
        err = k2_error(got, K2.torch_reference(xs, was, *rest), True)
        rows.append(dict(kernel="k2", model="random", call=0,
                         shape=_head_shape(m, k, nc, widths), dtype="bfloat16",
                         max_abs_err=err[0], max_rel_err=err[1],
                         bitwise_repeatable=same, ok=err[2] and same))
    # fp32 on the FMA pipes: ragged row tiles, narrow and odd widths; each
    # launched twice (same bits) and as K2' (the same out bits), out and h1
    # against the twin at the card tests' bars
    for m, k, nc, widths in K2_FP32_CASES:
        xs, was, rest = random_head(torch, g, m, k, nc, torch.float32,
                                    **widths)
        got = K2.fused_nin_head(xs, was, *rest)
        again = K2.fused_nin_head(xs, was, *rest)
        with_h1, h1 = K2.nin_head_fwd(xs, was, *rest, save_h1=True)
        same = torch.equal(got, again) and torch.equal(got, with_h1)
        ref, ref_h1 = K2.torch_reference_fwd(xs, was, *rest)
        e_out, e_h1 = fp32_error(got, ref, rtol=0), fp32_error(h1, ref_h1)
        rows.append(dict(kernel="k2", model="random", call=0,
                         shape=_head_shape(m, k, nc, widths), dtype="float32",
                         max_abs_err=max(e_out[0], e_h1[0]),
                         max_rel_err=max(e_out[1], e_h1[1]),
                         bitwise_repeatable=same,
                         ok=e_out[2] and e_h1[2] and same))
    torch.cuda.synchronize()
    report["kernel_vs_twin"] = rows
    for r in rows:
        print(f"  {r['kernel']} {r['model']:<20} {r['shape']:<28} {r['dtype']:<8} "
              f"max_abs {r['max_abs_err']:.3e} max_rel {r['max_rel_err']:.3e}"
              + (" bitwise-repeatable" if r.get("bitwise_repeatable") else "")
              + f" {'ok' if r['ok'] else 'FAIL'}")
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
    reset_counts()
    for (name, arm), fn in fns.items():
        k1_0, k2_0 = K1.launches, K2.launches
        params = models[name][1]
        out[name, arm] = [full.denoise_image(fn, params, y, sigma_vec(s))
                          for _, y, s in reqs[name]]
        per_arm[name, arm] = (K1.launches - k1_0, K2.launches - k2_0)
    launches = {"k1": K1.launches, "k2": K2.launches}
    report["main_path_launches"] = launches
    report["main_path_launches_per_arm"] = {
        f"{name}/{arm}": dict(zip(("k1", "k2"), n))
        for (name, arm), n in per_arm.items()}
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

    cfg, params_gpu = load_model("gauss25_rgb", DEVICE)
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
            busy, top = device_profile(
                torch, lambda: full.denoise_image(fn, params, y, pv))
            idle = 1 - busy / wall[name, arm]
            out[f"{name}/{arm}"] = dict(device_busy_ms=busy, idle_share=idle,
                                        top=top)
            print(f"  {name:<20} {arm:<12} device busy {busy:6.2f} ms, idle "
                  f"{idle:5.1%}: " + ", ".join(f"{k[:32]} {ms:.2f}"
                                               for k, ms, _ in top[:3]))
    report["profile"] = out


def time_calls(torch, kind, cs, reps):
    """K1 ("k1") or K2 ("k2") summed over the calls cs: kernel, twin and
    library ms (CUDA events), and the bound, per call in ``layers``."""
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    kern, twin, lib = {
        "k1": (K1.shifted_conv3x3_bias_act, K1.torch_reference, k1_library),
        "k2": (K2.fused_nin_head, K2.torch_reference, head_library)}[kind]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0)
    layers = []
    for args, kwargs in cs:
        row = {f: cuda_ms(torch, lambda fn=fn: fn(*args, **kwargs), reps)
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
    return dict(tot, layers=layers)


def time_kernels(torch, calls, launches, report, reps=10):
    """Per-request kernel time (sum over one request's calls) against the
    bound, the twin, and a library yardstick (timed only, never used)."""
    kernels = {
        "k1": ("shifted_conv3x3_bias_act", "ssdn_tpu_torch/csrc/shifted_conv.cu",
               "ssdn_tpu/ops/pallas/shifted_conv.py:80"),
        "k2": ("fused_nin_head", "ssdn_tpu_torch/csrc/nin_head.cu",
               "ssdn_tpu/ops/pallas/nin_head.py:107"),
    }
    per = {}
    for (kind, model), cs in calls.items():
        tot = per[kind, model] = time_calls(torch, kind, cs, reps)
        print(f"  {kernels[kind][0]} {model:<20} {tot['dtype']:<8} per "
              f"request: {tot['ms']:.3f} ms (bound {tot['bound_ms']:.3f} ms, "
              f"{tot['bound_by']}), twin {tot['plain_ms']:.3f} ms, "
              f"library {tot['library_ms']:.3f} ms, {len(cs)} launches")
    report["kernel_timing"] = {f"{k}:{m}": v for (k, m), v in per.items()}

    errs = report["kernel_vs_twin"]
    line = []
    for kind, (name, source, replaces) in kernels.items():
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
        # the fp32 model's request, and its launches on the serving path
        m32, v32 = next((m, v) for (k, m), v in per.items()
                        if k == kind and v["dtype"] == "float32")
        arm = "conv_pallas" if kind == "k1" else "head_pallas"
        line[-1]["per_request_fp32"] = dict(
            {f: v32[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")}, model=m32,
            launches=report["main_path_launches_per_arm"][f"{m32}/{arm}"][kind])
    return line


# ------------------------------ training ------------------------------


def reset_counts():
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    K1.launches = K2.launches = K2.launches_save_h1 = K2.launches_bwd = 0


def read_counts():
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    return {"k1": K1.launches, "k2": K2.launches,
            "k2_save_h1": K2.launches_save_h1, "k3": K2.launches_bwd}


@functools.lru_cache(maxsize=None)
def train_batch_u8(seed=0):
    """TRAIN_BATCH 64x64 crops of 8 smooth synthetic 256x256 images, uint8
    NHWC."""
    rng = np.random.default_rng(seed)
    images = [clean_image(300 + i, 256, 256) for i in range(8)]
    out = np.empty((TRAIN_BATCH, PATCH, PATCH, 3), np.uint8)
    for i in range(TRAIN_BATCH):
        r, c = rng.integers(0, 256 - PATCH, 2)
        crop = images[i % len(images)][r:r + PATCH, c:c + PATCH]
        out[i] = np.round((crop + 0.5) * 255)
    return out


def train_cfg(cfg, arm, **over):
    return dataclasses.replace(with_arm(cfg, arm), **over)


def blind_fixed_sigma(cfg):
    """The blind model's config with the injected noise at sigma 25 (still
    BLIND: the network estimates sigma from its extra channel), so the
    batch loss moves with the weights and not with the per-image sigma
    draws of its [5, 50] range."""
    return dataclasses.replace(cfg, noise=dataclasses.replace(
        cfg.noise, sigma_min=25.0, sigma_max=25.0))


def capture_training(torch, models, report):
    """Operands of K2' and K3 in one batch-384 training step of each model
    (head arm), and of K1 in one step of each model (conv arm: fp32 and
    bf16), recorded by wrapping the kernel wrappers."""
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1
    from ssdn_tpu_torch.train import make_train_step

    fwd, bwd, k1 = K2.nin_head_fwd, K2.nin_head_bwd, K1.shifted_conv3x3_bias_act
    calls = {}
    batch = train_batch_u8()
    try:
        for name, (cfg, params) in models.items():
            K2.nin_head_fwd = recorder(calls, ("k2p", name), fwd,
                                       when=lambda *a, save_h1: save_h1)
            K2.nin_head_bwd = recorder(calls, ("k3", name), bwd)
            ts = make_train_step(train_cfg(cfg, "head_pallas"), device=DEVICE)
            ts.loss_and_grads(params, *ts.noisy_batch(batch, 0))
            K1.shifted_conv3x3_bias_act = recorder(calls, ("k1t", name), k1)
            ts = make_train_step(train_cfg(cfg, "conv_pallas"), device=DEVICE)
            ts.loss_and_grads(params, *ts.noisy_batch(batch, 0))
            K1.shifted_conv3x3_bias_act = k1
    finally:
        K2.nin_head_fwd, K2.nin_head_bwd = fwd, bwd
        K1.shifted_conv3x3_bias_act = k1
    torch.cuda.synchronize()
    for key, c in calls.items():
        check(len(c) == (K1_PER_TRUNK if key[0] == "k1t" else 1),
              f"captured {len(c)} calls of {key}")
        if key[0] != "k1t":
            m = c[0][0][0][0].shape[0]
            check(m == TRAIN_BATCH * PATCH * PATCH, f"{key}: M = {m}")
    report["captured_training"] = {f"{k}:{n}": len(c)
                                   for (k, n), c in calls.items()}
    return calls


def k3_error(torch, got, ref, bf16, keep=None):
    """(max abs err, max rel err, ok) over all of K3's outputs, each held
    to a bar on its own range: fp32 1e-4 (sums over 1.5M rows, in other
    orders); bf16 2**-6 (h2, dpre2, dpre1 are rounded to bf16 on both
    sides, and one flipped rounding moves a result). ``keep``: the rows
    of dx_i compared (all if None)."""
    flat = lambda r: [*r[0], *r[1], *r[2:]]
    worst_abs, worst_rel, ok = 0.0, 0.0, True
    n_dx = len(got[0])
    for i, (a, b) in enumerate(zip(flat(got), flat(ref))):
        if a.dtype != b.dtype or a.shape != b.shape:
            return float("inf"), float("inf"), False
        if i < n_dx and keep is not None:
            a, b = a[keep], b[keep]
        e = k2_error(a.float(), b.float(), bf16)
        worst_abs, worst_rel = max(worst_abs, e[0]), max(worst_rel, e[1])
        ok = ok and e[2]
    return worst_abs, worst_rel, ok


def pre2_ties(torch, h1, wb, bb):
    """Rows whose pre2 = h1 Wb + bb (fp32) has an element within 2**-20 of
    pre2's range of zero. There dpre2's mask (pre2 >= 0) hangs on the
    summation order: the tensor cores' sum and cuBLAS's differ by about
    1e-7 (measured flips at |pre2| 4.5e-8 and 9.3e-8, range about 2), and
    a flipped mask scales one dpre2 by 10 and moves the row's dx by a few
    percent of dx's range. The weight grads, sums over all rows, still
    hold their bar with these rows in."""
    ties = torch.zeros(h1.shape[0], dtype=torch.bool, device=h1.device)
    pre_max = 0.0
    for pass_ in (0, 1):  # 0: the range; 1: the rows near zero
        for r in range(0, h1.shape[0], 1 << 18):
            pre2 = h1[r:r + (1 << 18)].float() @ wb.float() + bb.float()
            if pass_ == 0:
                pre_max = max(pre_max, pre2.abs().max().item())
            else:
                ties[r:r + (1 << 18)] = (pre2.abs() <= 2 ** -20 * pre_max).any(1)
    return ties


def random_head(torch, g, m, k, nc, dt, c=96, na=384, nb=96):
    xs = [(torch.randn(m, c, device=DEVICE, generator=g) * 0.5).to(dt)
          for _ in range(k)]
    was = [(torch.randn(c, na, device=DEVICE, generator=g) * 0.05).to(dt)
           for _ in range(k)]
    rest = [torch.randn(na, device=DEVICE, generator=g) * 0.1,
            (torch.randn(na, nb, device=DEVICE, generator=g) * 0.05).to(dt),
            torch.randn(nb, device=DEVICE, generator=g) * 0.1,
            (torch.randn(nb, nc, device=DEVICE, generator=g) * 0.1).to(dt),
            torch.randn(nc, device=DEVICE, generator=g) * 0.1]
    return xs, was, rest


# bf16 K1's extra cases (n, Cin, H, W, Cout), each launched twice (the same
# bits): Cin not a multiple of 8 (the gray models' 1, enc0's 3, the naive
# decoder's dec1a 99 and gray 97) or over one pass (its dec2a-dec4a 144), W
# of 2, 4 and 7 (tiles span images), and BSD68's 481x321 padded to 512x352
# in both orientations (W 352 is not a multiple of the 64-wide tile)
K1_BF16_CASES = [(2, 1, 512, 768, 48), (2, 3, 352, 512, 48),
                 (2, 97, 512, 352, 96), (2, 99, 352, 512, 96),
                 (2, 144, 176, 256, 96), (2, 144, 11, 16, 96),
                 (1536, 48, 2, 2, 48), (1536, 96, 4, 4, 96), (2, 48, 5, 7, 96),
                 (4, 1, 9, 7, 48), (2, 96, 352, 512, 96), (2, 48, 512, 352, 48)]


def k1_bf16_rows(torch, g):
    """bf16 K1 at ``K1_BF16_CASES`` on random operands: against the twin,
    and launched twice for the same bits."""
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    rows = []
    for n, cin, h, w_, cout in K1_BF16_CASES:
        x = torch.randn(n, cin, h, w_, device=DEVICE, generator=g)
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w = torch.randn(cout, cin, 3, 3, device=DEVICE, generator=g) * (
            2 / (9 * cin)) ** 0.5
        b = torch.randn(cout, device=DEVICE, generator=g) * 0.1
        got = K1.shifted_conv3x3_bias_act(x, w, b)
        same = torch.equal(got, K1.shifted_conv3x3_bias_act(x, w, b))
        err = k1_error(torch, got, K1.torch_reference(x, w, b))
        rows.append(dict(kernel="k1", model="random", call=0,
                         shape=f"{(n, cin, h, w_)}->{cout}", dtype="bfloat16",
                         max_abs_err=err[0], max_rel_err=err[1],
                         bitwise_repeatable=same, ok=err[2] and same))
    return rows


# bf16 K2 / K2''s extra cases (M, k, Nc, widths): ragged row counts for the
# tensor-core kernel's 128-row tiles, and the widths of the generic
# instantiation (not multiples of 16; the narrow model config's head)
K2_BF16_CASES = [(m, 4, 10, {}) for m in (1, 63, 65, 127, 129, 4133)] + [
    (1000, 4, 3, dict(c=40, na=72, nb=24)), (1000, 4, 9, dict(c=16, na=32, nb=16))]


# fp32 K2 / K2''s extra cases (M, k, Nc, widths): ragged row counts for the
# FMA kernel's 128-row tiles, the narrow widths, Na at MAX_NA, C 3 and 99
# (x rows off 16-byte boundaries: 4-byte pieces), and Nb 200 / Nc 40 (three
# passes over Nb, three groups of out's columns)
K2_FP32_CASES = [(m, 4, 10, {}) for m in (1, 63, 65, 127, 129, 4133)] + [
    (1000, 4, 3, dict(c=40, na=72, nb=24)), (1000, 4, 9, dict(c=16, na=32, nb=16)),
    (1000, 4, 10, dict(na=512)), (1000, 4, 10, dict(c=3)),
    (1000, 4, 10, dict(c=99)), (1000, 4, 40, dict(nb=200))]


def _head_shape(m, k, nc, widths):
    return f"M={m} k={k} n_out={nc}" + "".join(
        f" {n}={v}" for n, v in widths.items())


# K3's extra cases beyond a real step's operands (M, k, Nc, widths): ragged
# row counts for the tensor-core tiles (64 rows in (a), 32 per stage in
# (b)), and widths that are not multiples of 16 (C 40, Na 72, Nb 24, Nc 3)
K3_BF16_CASES = [(m, 4, 10, {}) for m in (1, 63, 65, 4133)] + [
    (4133, 4, 3, dict(c=40, na=72, nb=24)), (1000, 1, 3, dict(c=40, na=72, nb=24))]


# fp32 K3's extra cases (M, k, Nc, widths): ragged row counts for the FMA
# kernels' 128-row tiles, C 3 and 99 (rows off 16-byte boundaries: 4-byte
# pieces; dx chunks straddling branches), Na at MAX_NA, Nb 200 / Nc 40
# (three passes over Nb, three groups of Nc), the narrow widths, and C, Na,
# Nb not multiples of 4 (every operand in 4-byte pieces)
K3_FP32_CASES = [(m, 4, 10, {}) for m in (1, 63, 65, 127, 129, 4133)] + [
    (1000, 4, 10, dict(c=3)), (1000, 4, 10, dict(c=99)),
    (1000, 4, 10, dict(na=512)), (1000, 4, 40, dict(nb=200)),
    (1000, 4, 3, dict(c=40, na=72, nb=24)), (1000, 4, 9, dict(c=16, na=32, nb=16)),
    (1000, 4, 3, dict(c=5, na=70, nb=30))]


def training_kernels_vs_twins(torch, calls, report):
    """K2' (out and h1) and K3 (every output, launched twice and compared
    bit for bit) against their twins on the captured batch-384 operands
    and on random ragged ones and odd widths (K3: ``K3_BF16_CASES``,
    ``K3_FP32_CASES``); K1 at the training shapes."""
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    with torch.no_grad():
        return _training_kernels_vs_twins(torch, K1, K2, calls, report)


def _training_kernels_vs_twins(torch, K1, K2, calls, report):
    rows = []

    def k2p_row(model, args, shape):
        bf16 = args[0][0].dtype == torch.bfloat16
        out, h1 = K2.nin_head_fwd(*args, save_h1=True)
        out2, h1_2 = K2.nin_head_fwd(*args, save_h1=True)
        # K2 and K2' are one kernel: the same out bits
        same = (torch.equal(out, out2) and torch.equal(h1, h1_2)
                and torch.equal(out, K2.fused_nin_head(*args)))
        ref, ref_h1 = K2.torch_reference_fwd(*args)
        e_out = k2_error(out, ref, bf16)
        e_h1 = k1_error(torch, h1, ref_h1)  # one rounding of one fp32 sum
        rows.append(dict(kernel="k2p", model=model, call=0, shape=shape,
                         dtype=dname(torch, args[0][0].dtype),
                         max_abs_err=max(e_out[0], e_h1[0]),
                         max_rel_err=max(e_out[1], e_h1[1]),
                         bitwise_repeatable=same,
                         ok=e_out[2] and e_h1[2] and same))

    def k3_row(model, args, shape):
        bf16 = args[0][0].dtype == torch.bfloat16
        got = K2.nin_head_bwd(*args)
        again = K2.nin_head_bwd(*args)
        flat = lambda r: [*r[0], *r[1], *r[2:]]
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
        # bf16: dx_i is held on the rows whose dpre2 mask is not a tie
        ties = pre2_ties(torch, *args[2:5]) if bf16 else None
        n_ties = int(ties.sum()) if bf16 else 0
        e = k3_error(torch, got, K2.torch_reference_bwd(*args), bf16,
                     keep=None if ties is None else ~ties)
        m = args[0][0].shape[0]
        rows.append(dict(kernel="k3", model=model, call=0, shape=shape,
                         dtype=dname(torch, args[0][0].dtype),
                         max_abs_err=e[0], max_rel_err=e[1],
                         tie_rows=n_ties, bitwise_repeatable=same,
                         ok=e[2] and same and n_ties <= max(1, m // 1000)))

    for (kind, model), cs in calls.items():
        for i, (args, kwargs) in enumerate(cs):
            if kind == "k1t":
                x, w, b = args
                err = k1_error(torch, K1.shifted_conv3x3_bias_act(x, w, b, **kwargs),
                               K1.torch_reference(x, w, b, **kwargs))
                rows.append(dict(kernel="k1", model=model + " (train)", call=i,
                                 shape=f"{tuple(x.shape)}->{w.shape[0]}",
                                 dtype=dname(torch, x.dtype),
                                 max_abs_err=err[0], max_rel_err=err[1],
                                 ok=err[2]))
                continue
            xs = args[0]
            shape = f"M={xs[0].shape[0]} k={len(xs)} n_out={args[-1].shape[-1]}"
            if kind == "k2p":
                k2p_row(model, args, shape)
            else:
                k3_row(model, args, shape)
    g = torch.Generator(device=DEVICE).manual_seed(1)
    cases = [(dt, m, k, nc, {}) for dt in (torch.float32, torch.bfloat16)
             for m, k, nc in ((TRAIN_BATCH * PATCH * PATCH - 13, 4, 9),
                              (1000, 1, 2))]
    for m, k, nc, widths in K2_BF16_CASES:
        xs, was, rest = random_head(torch, g, m, k, nc, torch.bfloat16,
                                    **widths)
        k2p_row("random", (xs, was, *rest), _head_shape(m, k, nc, widths))
    n_k2p = len(cases)  # K2''s own bf16 cases ran above
    cases += [(torch.bfloat16, *case) for case in K3_BF16_CASES]
    cases += [(torch.float32, *case) for case in K3_FP32_CASES]
    for i, (dt, m, k, nc, widths) in enumerate(cases):
        xs, was, rest = random_head(torch, g, m, k, nc, dt, **widths)
        shape = _head_shape(m, k, nc, widths)
        if i < n_k2p:
            k2p_row("random", (xs, was, *rest), shape)
        gout = torch.randn(m, nc, device=DEVICE, generator=g)
        _, h1 = K2.torch_reference_fwd(xs, was, *rest)
        ba, wb, bb, wc, bc = rest
        k3_row("random", (xs, was, h1, wb, bb, wc, gout), shape)
        del xs, was, rest, h1, gout
    torch.cuda.synchronize()
    report["training_kernel_vs_twin"] = rows
    for r in rows:
        print(f"  {r['kernel']:<3} {r['model']:<26} {r['shape']:<28} "
              f"{r['dtype']:<8} max_abs {r['max_abs_err']:.3e} max_rel "
              f"{r['max_rel_err']:.3e}"
              + (" bitwise-repeatable" if r.get("bitwise_repeatable") else "")
              + (f" ({r['tie_rows']} tie rows)" if r.get("tie_rows") else "")
              + f" {'ok' if r['ok'] else 'FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"{len(bad)} training kernel-vs-twin comparisons failed")
    return rows


def _grad_leaves(grads):
    return {f"{n}.{k}": t for n, leaf in grads.items() for k, t in leaf.items()}


@contextlib.contextmanager
def autograd_twins():
    """The model's kernel entry points replaced by the kernels' plain twins
    under torch's own autograd: the kernel arms' forward rounding, with
    a backward that is neither K3 nor K1's custom one."""
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1
    from ssdn_tpu_torch.models import blindspot_unet as bu

    saved = bu.nin_head, bu.fused_shifted_conv
    bu.nin_head = lambda xs, was, *rest: K2.torch_reference_fwd(xs, was, *rest)[0]
    bu.fused_shifted_conv = K1.torch_reference
    try:
        yield
    finally:
        bu.nin_head, bu.fused_shifted_conv = saved


def _step0(torch, cfg, params, arm, batch, twins=False):
    from ssdn_tpu_torch.train import make_train_step

    ts = make_train_step(train_cfg(cfg, arm), device=DEVICE)
    with autograd_twins() if twins else contextlib.nullcontext():
        loss, _, grads = ts.loss_and_grads(params, *ts.noisy_batch(batch, 0))
    torch.cuda.synchronize()
    return loss.item(), _grad_leaves(grads)


def _compare(torch, got, ref):
    """loss_rel; grad_rel: the largest per-leaf max |diff| / max |ref|;
    min_cos: the least per-leaf cosine; global_cos: over all leaves."""
    (loss, g), (ref_loss, rg) = got, ref
    cos = lambda a, b: torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0).item()
    leaves = [k for k in rg if rg[k].abs().max() > 0]
    return dict(
        loss_rel=abs(loss - ref_loss) / abs(ref_loss),
        grad_rel=max(((g[k] - rg[k]).abs().max() / rg[k].abs().max()).item()
                     for k in leaves),
        min_cos=min(cos(g[k], rg[k]) for k in leaves),
        worst_leaf=min(leaves, key=lambda k: cos(g[k], rg[k])),
        global_cos=cos(torch.cat([g[k].flatten() for k in leaves]),
                       torch.cat([rg[k].flatten() for k in leaves])))


def _agreement_ok(dtype, arm, against, weights, c):
    """The bars. fp32: the head arm at 1e-4 of each leaf's max abs. The
    conv arm keeps the literal pool(lrelu(conv)) order (as the JAX
    package's kernel path does), so where LeakyReLU's rounding ties two
    values of a pooling window the max-pool backward routes that window to
    another pixel (the JAX package's kernel path does the same): cosine
    >= 0.9999 per leaf.
    Against the twins under autograd, fp32 sums taken in another order
    pass through the same pools and through sums with heavy cancellation
    (enc0's weight grad over 6.3M pixels): cosine >= 0.9999 and 1e-3 of
    each leaf's max abs. "lax (again)" repeats the torch-ops step, for the
    floor of cuDNN's run-to-run differences.
    bf16: the kernels round once where the torch ops round before each
    bias add; at the converged zoo weights the head's gradients are small
    residues of large per-pixel terms, and that forward rounding difference
    alone moves them (the K3 backward against autograd of the same forward
    agrees at cosine 0.99999), so against the torch-ops arm the per-leaf
    cosine bar (0.99) holds at the random init weights and the loss bar
    (1e-2) at both; against the twins under autograd (the same forward
    rounding) the per-leaf cosine bar holds at both."""
    if dtype == "float32":
        if against == "twins":
            return (c["loss_rel"] <= 1e-4 and c["min_cos"] >= 0.9999
                    and c["grad_rel"] <= 1e-3)
        if arm == "head_pallas":
            return c["loss_rel"] <= 1e-4 and c["grad_rel"] <= 1e-4
        return c["loss_rel"] <= 1e-4 and c["min_cos"] >= 0.9999
    if against == "lax" and weights == "zoo":
        return c["loss_rel"] <= 1e-2
    return c["loss_rel"] <= 1e-2 and c["min_cos"] >= 0.99


def train_agreement(torch, models, report):
    """Step 0 of each kernel arm on one batch-384 step, against the
    torch-ops arm and against the kernels' twins under autograd (the same
    forward rounding), at the zoo weights and (bf16) at random init weights;
    bars in ``_agreement_ok``. Then the card against the port's CPU step."""
    from ssdn_tpu_torch.train import init_state

    batch = train_batch_u8()
    rows = []
    for name, (cfg, zoo_params) in models.items():
        dtype = cfg.model.compute_dtype
        weights = {"zoo": zoo_params}
        if dtype == "bfloat16":
            weights["init"] = init_state(cfg, device=DEVICE).params
        for wname, params in weights.items():
            torch.cuda.reset_peak_memory_stats()
            ref = _step0(torch, cfg, params, "lax", batch)
            c = _compare(torch, _step0(torch, cfg, params, "lax", batch), ref)
            rows.append(dict(model=name, dtype=dtype, weights=wname,
                             arm="lax", against="lax (again)", loss=ref[0],
                             ok=True, **c))
            for arm in ("head_pallas", "conv_pallas"):
                reset_counts()
                got = _step0(torch, cfg, params, arm, batch)
                counts = read_counts()
                report.setdefault("train_agreement_launches", {})[
                    f"{name}/{wname}/{arm}"] = counts
                want = (dict(k1=0, k2=0, k2_save_h1=1, k3=1)
                        if arm == "head_pallas" else
                        dict(k1=K1_PER_TRUNK, k2=0, k2_save_h1=0, k3=0))
                check(counts == want, f"{name}/{wname}/{arm} step 0: "
                                      f"launches {counts}, expected {want}")
                twin = _step0(torch, cfg, params, arm, batch, twins=True)
                for against, r in (("lax", ref), ("twins", twin)):
                    c = _compare(torch, got, r)
                    rows.append(dict(model=name, dtype=dtype, weights=wname,
                                     arm=arm, against=against, loss=got[0],
                                     ok=_agreement_ok(dtype, arm, against,
                                                      wname, c), **c))
            report.setdefault("train_agreement_peak_mem_gb", {})[
                f"{name}/{wname}"] = torch.cuda.max_memory_allocated() / 1e9
    report["train_agreement"] = rows
    for r in rows:
        print(f"  {r['model']:<20} {r['dtype']:<8} {r['weights']:<4} "
              f"{r['arm']:<12} vs {r['against']:<6} loss rel "
              f"{r['loss_rel']:.1e} grad rel {r['grad_rel']:.1e} cos "
              f"{r['min_cos']:.6f} ({r['worst_leaf']}) global "
              f"{r['global_cos']:.6f} {'ok' if r['ok'] else 'FAIL'}")
    check(all(r["ok"] for r in rows), "a kernel arm's training step "
                                      "disagrees (see the rows above)")



def train_gpu_vs_cpu(torch, report):
    """Each arm's training step on the card against the same arm on the
    port's CPU (the twins there): fp32 gauss25_rgb at full width on two
    32x32 patches, the loss and each leaf's grad at 1e-4."""
    from ssdn_tpu_torch.train import make_train_step

    cfg, params_gpu = load_model("gauss25_rgb", DEVICE)
    _, params_cpu = load_model("gauss25_rgb", "cpu")
    rng = np.random.default_rng(9)
    x = np.stack([clean_image(400 + i, 32, 32) for i in range(2)])
    y = (x + rng.normal(0, 25 / 255, x.shape)).astype(np.float32)
    npar = {"sigma": np.full((2,), 25 / 255, np.float32)}

    def run(device, arm, params):
        t = lambda a: torch.from_numpy(a).to(device)
        ts = make_train_step(train_cfg(cfg, arm), device=device)
        loss, _, grads = ts.loss_and_grads(
            params, t(x), t(y), {k: t(v) for k, v in npar.items()})
        return loss.item(), {k: v.cpu() for k, v in _grad_leaves(grads).items()}

    diffs = {}
    for arm in ARMS:
        c = _compare(torch, run(DEVICE, arm, params_gpu),
                     run("cpu", arm, params_cpu))
        diffs[arm] = {k: c[k] for k in ("loss_rel", "grad_rel")}
    report["train_gpu_vs_cpu"] = diffs
    print(f"  card vs CPU training step (fp32, 32x32): {diffs}")
    check(all(d["loss_rel"] <= 1e-4 and d["grad_rel"] <= 1e-4
              for d in diffs.values()), f"card and CPU disagree: {diffs}")


def timed_steps(torch, ts, state, batch, warm, steps):
    """warm + steps training steps from ``state``: (state, the losses, the
    seconds of the last ``steps``, host clock to a synchronize)."""
    losses = []
    for i in range(warm + steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = ts(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return state, [float(v) for v in losses], time.perf_counter() - t0


def all_finite(torch, losses, state):
    return all(np.isfinite(losses)) and all(
        bool(torch.isfinite(t).all()) for leaf in state.params.values()
        for t in leaf.values())


def train(torch, models, report):
    """The training main path: TRAIN_STEPS steps of the bf16 blind model
    in each arm at batch 384 through ``make_train_step`` (uint8 batch,
    noise on the card, forward, backward, Adam), from the pretrained
    weights. Counts are read just around it. The loss must stay finite and
    fall; each arm's launches are checked; patches/s is timed over the
    steps after TRAIN_WARM."""
    from ssdn_tpu_torch.train import make_train_step, state_from_params

    cfg, params = models["gauss5_50_blind_rgb"]
    cfg = blind_fixed_sigma(cfg)
    batch = train_batch_u8()
    rows, per_arm = [], {}
    reset_counts()
    for arm in ARMS:
        ts = make_train_step(train_cfg(cfg, arm), device=DEVICE)
        state = state_from_params(params)
        before = read_counts()
        torch.cuda.reset_peak_memory_stats()
        steps = TRAIN_STEPS - TRAIN_WARM
        state, losses, dt = timed_steps(torch, ts, state, batch, TRAIN_WARM,
                                        steps)
        after = read_counts()
        per_arm[arm] = {k: after[k] - before[k] for k in after}
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        rows.append(dict(arm=arm, losses=losses, first5=first, last5=last,
                         finite=all_finite(torch, losses, state),
                         ms_per_step=dt / steps * 1e3,
                         patches_per_s=steps * TRAIN_BATCH / dt,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    launches = read_counts()
    report["train_launches"] = launches
    report["train_launches_per_arm"] = per_arm
    report["training"] = rows
    print(f"  training path launches: {launches}")
    for r in rows:
        print(f"  {r['arm']:<12} loss {r['first5']:.5f} (first 5) -> "
              f"{r['last5']:.5f} (last 5)  {r['ms_per_step']:.2f} ms/step  "
              f"{r['patches_per_s']:.1f} patches/s  peak "
              f"{r['peak_mem_gb']:.1f} GB")
    n = TRAIN_STEPS
    want = {"lax": dict(k1=0, k2=0, k2_save_h1=0, k3=0),
            "head_pallas": dict(k1=0, k2=0, k2_save_h1=n, k3=n),
            "conv_pallas": dict(k1=K1_PER_TRUNK * n, k2=0, k2_save_h1=0, k3=0)}
    for arm, counts in per_arm.items():
        check(counts == want[arm], f"{arm}: training launches {counts}, "
                                   f"expected {want[arm]}")
    for r in rows:
        check(r["finite"], f"{r['arm']}: non-finite loss or params")
        check(r["last5"] < r["first5"], f"{r['arm']}: the loss did not fall "
              f"({r['first5']:.5f} -> {r['last5']:.5f})")
    return launches, rows


def train_reference_fp32(torch, models, report):
    """The reference objective's fp32 training step, timed: the
    ``gauss25_rgb`` weights (trained under ``objective="reference"``, whose
    "auto" compute dtype is float32) at batch 384 through
    ``make_train_step``, REF_WARM warm-ups then REF_STEPS steps in the lax
    and head arms (the head arm runs K2' and K3 in fp32 once per step).
    Counts are read just around each arm; the loss and the weights must
    stay finite."""
    from ssdn_tpu_torch.train import make_train_step, state_from_params

    cfg, params = models["gauss25_rgb"]
    check(cfg.objective == "reference" and
          cfg.model.compute_dtype == "float32",
          f"gauss25_rgb: {cfg.objective} / {cfg.model.compute_dtype}")
    batch = train_batch_u8()
    rows, launches = [], {}
    for arm in REF_ARMS:
        ts = make_train_step(train_cfg(cfg, arm), device=DEVICE)
        state = state_from_params(params)
        reset_counts()
        state, losses, dt = timed_steps(torch, ts, state, batch, REF_WARM,
                                        REF_STEPS)
        launches[arm] = read_counts()
        rows.append(dict(arm=arm, ms_per_step=dt / REF_STEPS * 1e3,
                         patches_per_s=REF_STEPS * TRAIN_BATCH / dt,
                         first_loss=losses[0], last_loss=losses[-1],
                         finite=all_finite(torch, losses, state)))
    report["reference_training"] = rows
    report["reference_train_launches"] = launches
    print("  reference objective, fp32 gauss25_rgb, batch "
          f"{TRAIN_BATCH}, {REF_STEPS} steps after {REF_WARM}: " + "; ".join(
              f"{r['arm']} {r['ms_per_step']:.2f} ms/step "
              f"{r['patches_per_s']:.1f} patches/s" for r in rows))
    n = REF_WARM + REF_STEPS
    want = {"lax": dict(k1=0, k2=0, k2_save_h1=0, k3=0),
            "head_pallas": dict(k1=0, k2=0, k2_save_h1=n, k3=n)}
    for arm, counts in launches.items():
        check(counts == want[arm], f"reference {arm}: launches {counts}, "
                                   f"expected {want[arm]}")
    for r in rows:
        check(r["finite"], f"reference {r['arm']}: non-finite loss or params")
    return rows


def profile_train_step(torch, models, report):
    """Device busy time, by kernel name, of one batch-384 training step per
    arm (bf16 blind model), and the device's idle share of the timed step."""
    from ssdn_tpu_torch.train import make_train_step, state_from_params

    cfg, params = models["gauss5_50_blind_rgb"]
    cfg = blind_fixed_sigma(cfg)
    batch = train_batch_u8()
    wall = {r["arm"]: r["ms_per_step"] for r in report["training"]}
    out = {}
    for arm in ARMS:
        ts = make_train_step(train_cfg(cfg, arm), device=DEVICE)
        state, _ = ts(state_from_params(params), batch)
        busy, top = device_profile(torch, lambda: ts(state, batch))
        idle = 1 - busy / wall[arm]
        out[arm] = dict(device_busy_ms=busy, step_ms=wall[arm],
                        idle_share=idle, top=top)
        print(f"  train {arm:<12} device busy {busy:7.2f} ms of "
              f"{wall[arm]:7.2f} ms, idle {idle:5.1%}: "
              + ", ".join(f"{k[:30]} {ms:.2f}" for k, ms, _ in top[:3]))
    report["train_profile"] = out


def k3_cost(torch, xs, was, h1, wb, wc):
    """K3's least time: bytes (inputs read once, outputs written once) and
    operations (2 * (3 Na Nb + 2 Nb Nc + 2 k C Na) per row)."""
    m, c = xs[0].shape
    k, na, nb, nc = len(xs), h1.shape[1], wb.shape[1], wc.shape[1]
    es = xs[0].element_size()
    nbytes = (2 * k * m * c * es + m * na * es + m * nc * 4
              + (k * c * na + na * nb + nb * nc) * es + nb * 4
              + (k * c * na + na + na * nb + nb + nb * nc + nc) * 4)
    ops = 2 * m * (3 * na * nb + 2 * nb * nc + 2 * k * c * na)
    return bound(nbytes, ops, dname(torch, xs[0].dtype))


def k3_library(torch, args):
    """K3's library yardstick on K3's operands: a function that runs the
    autograd backward of the torch-ops head (``head_library``; its forward
    built once, here, outside any timing; ba and bc, which K3 does not
    read, are zeros). Timed only, never used by the port."""
    xs, was, h1, wb, bb, wc, g = args
    ba0 = torch.zeros(h1.shape[1], device=h1.device)
    bc0 = torch.zeros(g.shape[1], device=g.device)
    leaves = [t.detach().requires_grad_(True)
              for t in (*xs, *was, ba0, wb, bb, wc, bc0)]
    k = len(xs)
    with torch.enable_grad():
        out = head_library(leaves[:k], leaves[k:2 * k], *leaves[2 * k:])
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


# K3's kernels by name prefix: (a) the rows kernel (fp32: (a1), pre2 to
# dpre1; bf16: the whole of (a)), fp32's (a2) dx kernel, (b) the
# weight-grad partials, (c) the split reduction
K3_PARTS = {"rows": "bwd_rows", "dx": "bwd_dx", "wgrad": "wgrad_",
            "reduce": "reduce_splits"}


def k3_parts(torch, fn, reps):
    """K3's device ms per call, split into its launches (``K3_PARTS``; bf16
    has no dx launch): torch.profiler's device events over reps calls of fn
    (warmed)."""
    fn()
    _, top = device_profile(torch, lambda: [fn() for _ in range(reps)])
    return {part: sum(ms for name, ms, _ in top if prefix in name) / reps
            for part, prefix in K3_PARTS.items()}


def time_training_kernels(torch, calls, report, reps=5):
    """Per-step time of K2', K3 and K1 (training shapes) against the bound,
    the twin and a library yardstick (timed only, never used): three
    ``addmm`` for the head forward, the torch-ops head's autograd backward
    (cuBLAS) for K3, cuDNN conv + LeakyReLU for K1."""
    from ssdn_tpu_torch.kernels import nin_head as K2

    per = {}
    for (kind, model), cs in calls.items():
        if kind == "k1t":
            tot = dict(time_calls(torch, "k1", cs, reps),
                       launches_per_step=len(cs))
        else:
            args = cs[0][0]
            xs, was = args[0], args[1]
            if kind == "k2p":
                ms = cuda_ms(torch, lambda: K2.nin_head_fwd(*args, save_h1=True),
                             reps)
                plain = cuda_ms(torch, lambda: K2.torch_reference_fwd(*args), reps)
                lib = cuda_ms(torch, lambda: head_library(*args), reps)
                b_ms, by = k2_cost(torch, xs, was, args[3], args[5],
                                   save_h1=True)
            else:
                h1, wb, bb, wc, g = args[2:]
                ms = cuda_ms(torch, lambda: K2.nin_head_bwd(*args), reps)
                plain = cuda_ms(torch, lambda: K2.torch_reference_bwd(*args), reps)
                lib = cuda_ms(torch, k3_library(torch, args), reps)
                b_ms, by = k3_cost(torch, xs, was, h1, wb, wc)
            tot = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                       bound_by=by, dtype=dname(torch, xs[0].dtype),
                       launches_per_step=1)
            if kind == "k3":
                tot["parts_ms"] = k3_parts(
                    torch, lambda: K2.nin_head_bwd(*args), reps)
        per[kind, model] = tot
        print(f"  {kind:<3} {model:<20} {tot['dtype']:<8} per step: "
              f"{tot['ms']:.3f} ms (bound {tot['bound_ms']:.3f} ms, "
              f"{tot['bound_by']}), twin {tot['plain_ms']:.3f} ms, library "
              f"{tot['library_ms']:.3f} ms, {tot['launches_per_step']} launches"
              + "".join(f", ({part}) {v:.3f} ms"
                        for part, v in tot.get("parts_ms", {}).items()))
    report["training_kernel_timing"] = {f"{k}:{m}": v for (k, m), v in per.items()}
    return per


def training_line(report, timing, launches):
    """The K2' and K3 entries of the kernels line, per batch-384 training
    step of the bf16 model (the flagship's dtype)."""
    errs = report["training_kernel_vs_twin"]
    line = []
    for kind, name, source, replaces, count in (
            ("k2p", "nin_head_fwd(save_h1=True)",
             "ssdn_tpu_torch/csrc/nin_head.cu",
             "ssdn_tpu/ops/pallas/nin_head.py:296", launches["k2_save_h1"]),
            ("k3", "nin_head_bwd", "ssdn_tpu_torch/csrc/nin_head_bwd.cu",
             "ssdn_tpu/ops/pallas/nin_head.py:223", launches["k3"])):
        model, v = next((m, v) for (k, m), v in timing.items()
                        if k == kind and v["dtype"] == "bfloat16")
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=count,
            max_abs_err=max(r["max_abs_err"] for r in errs
                            if r["kernel"] == kind and r["model"] == model),
            ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
            bound_by=v["bound_by"], library_ms=v["library_ms"],
            per=f"one batch-{TRAIN_BATCH} training step", dtype=v["dtype"],
            model=model, **({"parts_ms": v["parts_ms"]} if kind == "k3" else {})))
        # the fp32 model's step 0, and its launches on that path
        m32, v32 = next((m, v) for (k, m), v in timing.items()
                        if k == kind and v["dtype"] == "float32")
        key = {"k2p": "k2_save_h1", "k3": "k3"}[kind]
        line[-1]["per_train_step_fp32"] = dict(
            {f: v32[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "parts_ms") if f in v32},
            model=m32,
            launches=report["train_agreement_launches"][
                f"{m32}/zoo/head_pallas"][key],
            launches_reference_training=report["reference_train_launches"][
                "head_pallas"][key])
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
    models = {name: load_model(name, DEVICE) for name in MODELS}
    calls = capture_operands(torch, models, report)
    kernels_vs_twins(torch, calls, report)
    train_calls = capture_training(torch, models, report)
    training_kernels_vs_twins(torch, train_calls, report)
    train_timing = time_training_kernels(torch, train_calls, report)
    del train_calls

    print("[4] main path, serving: 5 requests x 3 arms x 2 models")
    launches = serve(torch, models, report)
    check(launches["k1"] > 0 and launches["k2"] > 0,
          f"a kernel was not launched on the serving path: {launches}")
    gpu_vs_cpu(torch, report)

    print(f"[5] main path, training: {TRAIN_STEPS} steps x 3 arms at batch "
          f"{TRAIN_BATCH}")
    train_agreement(torch, models, report)
    train_gpu_vs_cpu(torch, report)
    train_launches, _ = train(torch, models, report)
    check(all(train_launches[k] > 0 for k in ("k1", "k2_save_h1", "k3")),
          f"a kernel was not launched on the training path: {train_launches}")
    train_reference_fp32(torch, models, report)

    print("[6] timing")
    time_requests(torch, models, report)
    profile_request(torch, models, report)
    profile_train_step(torch, models, report)
    kernel_line = time_kernels(torch, calls, launches, report)
    kernel_line += training_line(report, train_timing, train_launches)
    for entry in kernel_line:
        if entry["name"] == "shifted_conv3x3_bias_act":
            entry["launches"] += train_launches["k1"]
            entry["launches_by_path"] = {"serving": launches["k1"],
                                         "training": train_launches["k1"]}
            for key, dt in (("per_train_step", "bfloat16"),
                            ("per_train_step_fp32", "float32")):
                t = next(v for (k, _), v in train_timing.items()
                         if k == "k1t" and v["dtype"] == dt)
                entry[key] = {f: t[f] for f in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "launches_per_step")}

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
