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
   K1 in both dtypes at Cin 1, 3, 97, 99, 144, W 2, 4, 7 and BSD68's
   512x352, fp32 K1 also at Cin 512 and at a tile staged in passes; K3 and
   K1 each launched twice and compared bit for bit);
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
   10 steps in the lax, head and conv arms (K2' / K3 fp32 once per step in
   the head arm, fp32 K1 12 times per step in the conv arm);
6. times each arm per 768x512 request and per training step (patches/s),
   profiles one request and one step per arm (device busy and idle share),
   and each kernel per request against its bound, its twin and a library
   yardstick (the kernels line: the bf16 model's numbers, the fp32 model's
   under ``per_request_fp32`` / ``per_train_step_fp32``); the bf16 trunk
   conv's epilogue (``conv_epilogue``, forward and backward) per batch-384
   step and per 768x512 request against its bound and twin (and equal to
   the twin), and the pad fold's A/B at the step's shifted convs; its
   launches are counted on the main paths themselves ([4], [5], [7]-[9]:
   12 + 12 a square bf16 step, 14 + 14 under the torch-ops head, 5 + 5
   plus the head's 2 + 2 beside K1, 24 a non-square bf16 request, none in
   fp32), and the kernels line gives them by path;
7. the Trainer path: the flagship at full width from random init (RGB,
   Gaussian sigma 25 known, 64x64 patches at batch 384, stabilized
   objective, bf16 trunk) trains 40 steps with eval (``synthetic:4:512``)
   and snapshots every 20 steps in two arms: the conv arm through
   ``cli.train.main`` (K1, native sampler on ``synthetic:64:128``), the
   head arm through ``Trainer`` (K2' and K3 per step, K2 per eval;
   streaming sampler on ``synthetic:inf:128``). Each run's loss is finite
   and falls from step 10 to 40, its workdir holds ckpt/, ckpt_best/,
   best_psnr.json, metrics.jsonl and sampler_backend.json, and its
   launches are counted exactly. A head-arm run preempted after its
   step-20 snapshot and resumed by a new Trainer is held to the
   uninterrupted run's params (``RESUME_BAR``; whether the bits match is
   printed), and two resumes with a planted fault (the optimizer state
   zeroed; the batches of steps 0-19 again) must read above that bar;
   ``cli.denoise --workdir`` serves a 768x512 image from the
   conv arm's workdir through K1. It records the Trainer's own patches/s
   beside [5]'s fixed-batch window, the device idle share over ten
   profiled Trainer steps, and the host samplers' rates. The kernels
   line's ``launches_by_path`` gains ``trainer``; [7]'s workdirs stay
   for [8];
8. the tiled and aux paths: (a) ``tiled_denoise_sequential`` (windows of
   512 + 2 x 320 columns) of a smooth 2048x1536 image at sigma 25 with
   ``gauss25_rgb`` (fp32) in each arm, held to the lax arm's tiled
   result and to the arm's own full-image ``denoise_image`` at 1e-4
   (whether the bits match is printed), each arm's full image held to the
   lax arm's at 1e-4, K1 launching 24 times per window in the conv arm
   and K2 once per window in the head arm, counted around each sequential
   call; (b) the same with ``gauss5_50_blind_rgb`` (bf16): each kernel
   arm against the lax arm at [4]'s bar, the PSNR 3 dB over the noisy
   one, the tiled-vs-full PSNR gap printed (the blind estimate is per
   window); (c) peak device memory and time of the full image and of
   sequential windows at 2048x1536, and of sequential windows at
   4032x3024 (head arm, fp32); (d) ``cli.denoise --pretrained gauss25_rgb
   --tiled sequential`` on a 2048x1536 PNG writes the library call's PNG
   bytes; (e) ``tools.blind_calibration`` on ``gauss5_50_blind_rgb`` at
   sigma 5, 15, 25, 40, 50 (8 images of 128 px each): the estimates rise
   with the true value. (d) and (e) run the artifacts in their recorded
   arm, lax/lax, and launch no kernel; (f) ``tools.export_pretrained`` of [7]'s conv-arm workdir,
   loaded with ``zoo.load``, serves [7]'s 768x512 request bit for bit as
   ``cli.denoise --workdir`` did. The kernels line's ``launches_by_path``
   gains ``tiled`` for K1 and K2;
9. data parallelism and sharded tiling, each rank a process of its own
   (``--worker``, launched by ``torch.distributed.run``): (a) DP training
   at world size 1 over NCCL (the conv arm through ``cli.train
   --data-parallel``, the head arm through ``Trainer(group=)``; the
   flagship, batch 384, 15 steps) held to one process's run at
   ``RESUME_BAR``, cuDNN held to its deterministic algorithms in these
   runs so that the bits read the DP arithmetic alone; (b) world size 2 over gloo, both ranks on the one card,
   held to it at ``_agreement_ok``'s bf16 bar; K1 12 per step (conv), K2'
   and K3 1 per step (head) in every rank; the gradient all-reduce and
   the global batch's noise timed; (c) sharded tiling of [8]'s image at
   world sizes 1 (NCCL) and 2 (gloo): both models in every arm by the
   window modes (x2: exchange, 1664-wide windows), the lax arm per level,
   and [4]'s first request (x2: gather); every rank returns the same
   image, fp32 held to the lax arm's and to the untiled image at 1e-4,
   bf16 at [4]'s bar (the per-level blind model to the untiled image),
   K1 24 and K2 1 launches per window per rank, the per-level messages
   counted and timed; (d) at world size 1 ``cli.denoise --tiled
   sharded`` and ``cli.evaluate --data-parallel`` write the library
   calls' PNG bytes; (e) where the machine has more cards, (a)-(c) at
   their count over NCCL. The kernels line's ``launches_by_path`` gains
   ``dp_training`` and ``sharded``.

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
import shutil
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
# the bf16 trunk conv's epilogue (bf16 channels_last only, never fp32):
# enc0, enc6, dec5a-dec1a, dec5b-dec1b a trunk call; dec5a-dec1a alone
# where K1 runs the rest; the torch-ops head's nin_a, nin_b once a forward
EPI_PER_TRUNK, EPI_PER_TRUNK_K1, EPI_TORCH_HEAD = 12, 5, 2
TRAIN_BATCH = 384    # the flagship training batch (bench.py's headline)
PATCH = 64           # training patch side
TRAIN_STEPS = 30     # steps per arm on the training path
TRAIN_WARM = 5       # steps before the patches/s clock starts
# the reference objective's fp32 training step (gauss25_rgb): timed steps
# after warm-ups, per arm
REF_ARMS = ("lax", "head_pallas", "conv_pallas")
REF_STEPS, REF_WARM = 10, 3
# the Trainer path ([7]): the flagship at full width from random init,
# trained through the entry points; log / eval-and-snapshot intervals
TRAINER_STEPS, TRAINER_LOG, TRAINER_EVAL = 40, 10, 20
TRAINER_EVAL_DATA = "synthetic:4:512"
TRAINER_DIR = "build/chip_smoke_trainer"   # under the checkout, gitignored
# exact resume on the card: the resumed run's params against the
# uninterrupted run's, ||resumed - full|| <= RESUME_BAR ||full - init||
# over all params (cuDNN's backward need not be deterministic; the bits
# are reported, not required). Two resumes with a planted fault (RESUME_
# FAULTS) must read above the bar, or the bar could not tell them.
RESUME_BAR = 1e-3
RESUME_FAULTS = ("opt_state_zeroed", "batches_from_step_0")
# the tiled and aux paths ([8]): sequential windows of TILE_W + 2 * HALO
# columns on a wide photo and on a 12 MP camera frame (H, W)
TILE_W, HALO = 512, 320
TILED_HW = (1536, 2048)
CAMERA_HW = (3024, 4032)
TILED_REPS = 3       # timed calls per row of [8c], after one warm-up
CAL_IMAGES, CAL_SIZE = 8, 128   # blind_calibration's images per value


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
    rows += k1_odd_rows(torch, g, torch.bfloat16, K1_BF16_CASES)
    rows += k1_odd_rows(torch, g, torch.float32, K1_FP32_CASES)
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
        before = read_counts()
        params = models[name][1]
        out[name, arm] = [full.denoise_image(fn, params, y, sigma_vec(s))
                          for _, y, s in reqs[name]]
        after = read_counts()
        per_arm[name, arm] = tuple(after[k] - before[k]
                                   for k in ("k1", "k2", "epi", "epi_bwd"))
    counts = read_counts()
    launches = {k: counts[k] for k in ("k1", "k2", "epi")}
    report["main_path_launches"] = launches
    report["main_path_launches_per_arm"] = {
        f"{name}/{arm}": dict(zip(("k1", "k2", "epi", "epi_bwd"), n))
        for (name, arm), n in per_arm.items()}
    print(f"  main path launches: K1 {launches['k1']}, K2 {launches['k2']}, "
          f"conv epilogue {launches['epi']}")

    for (name, arm), got in per_arm.items():
        n = len(reqs[name])   # each non-square: two trunk calls a request
        bf16 = models[name][0].model.compute_dtype == "bfloat16"
        want = {"lax": (0, 0), "head_pallas": (0, n),
                "conv_pallas": (2 * K1_PER_TRUNK * n, 0)}[arm] + (
                    n * epi_per_forward(arm, 2, bf16), 0)
        check(got == want, f"{name}/{arm}: launches K1, K2, epilogue "
                           f"forward, backward {got}, expected {want}")
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
    from ssdn_tpu_torch.kernels import conv_epilogue as E
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    K1.launches = K2.launches = K2.launches_save_h1 = K2.launches_bwd = 0
    E.launches = E.launches_bwd = 0


def read_counts():
    from ssdn_tpu_torch.kernels import conv_epilogue as E
    from ssdn_tpu_torch.kernels import nin_head as K2
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    return {"k1": K1.launches, "k2": K2.launches,
            "k2_save_h1": K2.launches_save_h1, "k3": K2.launches_bwd,
            "epi": E.launches, "epi_bwd": E.launches_bwd}


def epi_per_forward(arm, trunk_calls=1, bf16=True):
    """The conv epilogue's launches in one forward of ``arm`` with
    ``trunk_calls`` trunk calls (1 square, 2 non-square), and as many in
    its backward: 0 in fp32; K1's arm leaves it dec5a-dec1a; the torch-ops
    head (the lax head, and every head beside K1) adds nin_a and nin_b."""
    if not bf16:
        return 0
    conv, head = ARMS[arm]
    per_trunk = EPI_PER_TRUNK_K1 if conv == "pallas" else EPI_PER_TRUNK
    fused_head = head == "pallas" and conv != "pallas"
    return per_trunk * trunk_calls + (0 if fused_head else EPI_TORCH_HEAD)


def epi_counts(arm, steps, forwards=0, bf16=True):
    """{"epi", "epi_bwd"} of ``steps`` square training steps and
    ``forwards`` more square forwards (evals) of ``arm``."""
    e = epi_per_forward(arm, 1, bf16)
    return dict(epi=e * (steps + forwards), epi_bwd=e * steps)


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
# fp32 K1: the same, and Cin 512 (its halo'd tile staged in passes over
# Cin, re-staged per tap) and Cin 144 at W 1 (a tile of one column whose
# 130 x 3 slots need two passes)
K1_FP32_CASES = K1_BF16_CASES + [(2, 512, 64, 64, 96), (2, 512, 11, 7, 48),
                                 (4, 144, 40, 1, 96)]


def same_bits(torch, a, b):
    """Equal bit patterns (torch.equal calls -0.0 equal to +0.0)."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a.view(it), b.view(it))


def k1_odd_rows(torch, g, dtype, cases):
    """K1 at ``cases`` on random operands in ``dtype``: against the twin,
    and launched twice for the same bits."""
    from ssdn_tpu_torch.kernels import shifted_conv as K1

    rows = []
    for n, cin, h, w_, cout in cases:
        x = torch.randn(n, cin, h, w_, device=DEVICE, generator=g)
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        w = torch.randn(cout, cin, 3, 3, device=DEVICE, generator=g) * (
            2 / (9 * cin)) ** 0.5
        b = torch.randn(cout, device=DEVICE, generator=g) * 0.1
        got = K1.shifted_conv3x3_bias_act(x, w, b)
        same = same_bits(torch, got, K1.shifted_conv3x3_bias_act(x, w, b))
        err = k1_error(torch, got, K1.torch_reference(x, w, b))
        rows.append(dict(kernel="k1", model="random", call=0,
                         shape=f"{(n, cin, h, w_)}->{cout}",
                         dtype=dname(torch, dtype), max_abs_err=err[0],
                         max_rel_err=err[1], bitwise_repeatable=same,
                         ok=err[2] and same))
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
# row counts for the tensor-core tiles (128 rows in (a), 64 per stage in
# (b)), widths that are not multiples of 16 (C 40, Na 72, Nb 24, Nc 3), Nb
# past one pass of 96 (128 at the model's Na; 600 at Na 64) and Nc past
# one window of Wc^T (100)
K3_BF16_CASES = [(m, 4, 10, {}) for m in (1, 63, 65, 4133)] + [
    (4133, 4, 3, dict(c=40, na=72, nb=24)), (1000, 1, 3, dict(c=40, na=72, nb=24)),
    (4133, 4, 10, dict(nb=128)), (1000, 4, 10, dict(na=64, nb=600)),
    (1000, 4, 100, {})]


# fp32 K3's extra cases (M, k, Nc, widths): ragged row counts for the FMA
# kernels' 128-row tiles, C 3 and 99 (rows off 16-byte boundaries: 4-byte
# pieces; dx chunks straddling branches), Na at MAX_NA, Nb 200 / Nc 40
# (three passes over Nb, three groups of Nc), the narrow widths, C, Na, Nb
# not multiples of 4 (every operand in 4-byte pieces), and M at the weight
# grads' split boundaries whose splits are not multiples of (b)'s 32-row
# stage: one split of 4,095 rows, 2,049 + 2,048, 3 x 2,731, 64 of 4,097
K3_FP32_CASES = [(m, 4, 10, {}) for m in (1, 63, 65, 127, 129, 4133)] + [
    (1000, 4, 10, dict(c=3)), (1000, 4, 10, dict(c=99)),
    (1000, 4, 10, dict(na=512)), (1000, 4, 40, dict(nb=200)),
    (1000, 4, 3, dict(c=40, na=72, nb=24)), (1000, 4, 9, dict(c=16, na=32, nb=16)),
    (1000, 4, 3, dict(c=5, na=70, nb=30))] + [
    (m, 4, 10, {}) for m in (4095, 4097, 8193, 262_145)]


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
        # at most one tie row in 1,000, and past Nb 96 one per 96 columns of
        # pre2: a tie is an element near zero, so a row of Nb elements is
        # one Nb / 96 times as often
        m, nb = args[0][0].shape[0], max(args[3].shape[1], 96)
        rows.append(dict(kernel="k3", model=model, call=0, shape=shape,
                         dtype=dname(torch, args[0][0].dtype),
                         max_abs_err=e[0], max_rel_err=e[1],
                         tie_rows=n_ties, bitwise_repeatable=same,
                         ok=e[2] and same
                         and n_ties <= max(1, m * nb // 96_000)))

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
                want = dict((dict(k1=0, k2=0, k2_save_h1=1, k3=1)
                             if arm == "head_pallas" else
                             dict(k1=K1_PER_TRUNK, k2=0, k2_save_h1=0, k3=0)),
                            **epi_counts(arm, 1,
                                         bf16=dtype == "bfloat16"))
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
        w = dict(want[arm], **epi_counts(arm, n))
        check(counts == w, f"{arm}: training launches {counts}, expected {w}")
    for r in rows:
        check(r["finite"], f"{r['arm']}: non-finite loss or params")
        check(r["last5"] < r["first5"], f"{r['arm']}: the loss did not fall "
              f"({r['first5']:.5f} -> {r['last5']:.5f})")
    return launches, rows


def train_reference_fp32(torch, models, report):
    """The reference objective's fp32 training step, timed: the
    ``gauss25_rgb`` weights (trained under ``objective="reference"``, whose
    "auto" compute dtype is float32) at batch 384 through
    ``make_train_step``, REF_WARM warm-ups then REF_STEPS steps in each of
    REF_ARMS (the head arm runs K2' and K3 in fp32 once per step, the conv
    arm fp32 K1 K1_PER_TRUNK times per step).
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
    none = dict(epi=0, epi_bwd=0)   # fp32: the epilogue never runs
    want = {"lax": dict(k1=0, k2=0, k2_save_h1=0, k3=0, **none),
            "head_pallas": dict(k1=0, k2=0, k2_save_h1=n, k3=n, **none),
            "conv_pallas": dict(k1=K1_PER_TRUNK * n, k2=0, k2_save_h1=0, k3=0,
                                **none)}
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


# ------------------------- the bf16 trunk conv's epilogue -------------------------


def epilogue_layers(h, w):
    """The epilogue's launches in one trunk call on (h, w) images, as (name,
    C, H, W, Hc, shift, act): enc0 and enc6 (crop), the decoder's sums
    dec5a..dec1a, dec5b..dec2b (crop) and dec1b (crop and shift, a
    pre-activation under the fused head)."""
    layers = [("enc0", 48, h, w, h + 2, 0, True),
              ("enc6", 48, h // 32, w // 32, h // 32 + 2, 0, True)]
    for s in (5, 4, 3, 2, 1):
        hh, ww = h >> (s - 1), w >> (s - 1)
        layers.append((f"dec{s}a", 96, hh, ww, hh, 0, True))
        layers.append((f"dec{s}b", 96, hh, ww, hh + 2, int(s == 1), s > 1))
    return layers


def epilogue_bytes(n, c, h, w, hc, shift, act):
    """(forward, backward) bytes the kernels must move: each element of c,
    g and out they read once, of out and dpre they write once (bf16)."""
    live = n * (h - shift) * w * c * 2
    return live + n * h * w * c * 2, live * (2 if act else 1) + n * hc * w * c * 2


def time_epilogue(torch, calls, reps):
    """Forward and backward epilogue (kernel, twin) over ``calls`` = [(n,
    layer)], CUDA events, against their bounds (bytes / 3.35 TB/s)."""
    from ssdn_tpu_torch.kernels import conv_epilogue as E

    tot = dict(fwd_ms=0.0, bwd_ms=0.0, fwd_plain_ms=0.0, bwd_plain_ms=0.0,
               fwd_bound_ms=0.0, bwd_bound_ms=0.0)
    layers = []
    g = torch.Generator(device=DEVICE).manual_seed(0)
    for n, (name, c, h, w, hc, shift, act) in calls:
        slope = 0.1 if act else None
        cl = torch.channels_last
        c0 = torch.randn((n, c, hc, w), generator=g, device=DEVICE).to(
            torch.bfloat16).contiguous(memory_format=cl)
        b = torch.randn((c,), generator=g, device=DEVICE)
        gr = torch.randn((n, c, h, w), generator=g, device=DEVICE).to(
            torch.bfloat16).contiguous(memory_format=cl)
        out = E.epilogue_fwd(c0, b, h, shift, slope)
        check(torch.equal(out, E.torch_reference(c0, b, h, shift, slope))
              and torch.equal(E.epilogue_bwd(gr, out, hc, shift, slope),
                              E.torch_reference_bwd(gr, out, hc, shift, slope)),
              f"conv epilogue differs from its twin at {name} n {n}")
        fb, bb = epilogue_bytes(n, c, h, w, hc, shift, act)
        row = dict(
            layer=name, shape=f"n {n} C {c} {h}x{w} from {hc} rows, shift "
            f"{shift}, act {act}",
            fwd_ms=cuda_ms(torch, lambda: E.epilogue_fwd(c0, b, h, shift,
                                                         slope), reps),
            bwd_ms=cuda_ms(torch, lambda: E.epilogue_bwd(gr, out, hc, shift,
                                                         slope), reps),
            fwd_plain_ms=cuda_ms(torch, lambda: E.torch_reference(
                c0, b, h, shift, slope), reps),
            bwd_plain_ms=cuda_ms(torch, lambda: E.torch_reference_bwd(
                gr, out, hc, shift, slope), reps),
            fwd_bound_ms=fb / PEAK_BYTES * 1e3, bwd_bound_ms=bb / PEAK_BYTES * 1e3)
        layers.append(row)
        for f in tot:
            tot[f] += row[f]
        del c0, gr, out
    return dict(tot, layers=layers)


def pad_fold_ab(torch, n, reps):
    """The pad fold's A/B at the step's shifted 3x3 convs (n images): (A)
    ``F.pad`` then a VALID conv, its backward, and the pad's backward copy
    of dx; (B) the conv with cuDNN's symmetric padding (2, 1) over H + 2
    output rows and its backward with the same padding. CUDA events of
    forward + backward per layer, bf16 channels_last."""
    import torch.nn.functional as F

    cl = torch.channels_last
    g = torch.Generator(device=DEVICE).manual_seed(1)
    layers = [("enc0", 3, 48, 64), ("enc6", 48, 48, 2), ("dec5b", 96, 96, 4),
              ("dec4b", 96, 96, 8), ("dec3b", 96, 96, 16),
              ("dec2b", 96, 96, 32), ("dec1b", 96, 96, 64)]
    rows, tot = [], {"pad_valid_ms": 0.0, "folded_ms": 0.0}
    for name, cin, cout, h in layers:
        x = torch.randn((n, cin, h, h), generator=g, device=DEVICE).to(
            torch.bfloat16).contiguous(memory_format=cl)
        w = (torch.randn((cout, cin, 3, 3), generator=g, device=DEVICE)
             * 0.1).to(torch.bfloat16)
        dc = torch.randn((n, cout, h, h), generator=g, device=DEVICE).to(
            torch.bfloat16).contiguous(memory_format=cl)
        dcf = torch.zeros((n, cout, h + 2, h), device=DEVICE,
                          dtype=torch.bfloat16).contiguous(memory_format=cl)
        dcf[:, :, :h] = dc
        mask = (True, True, False)

        def pad_valid():
            xp = F.pad(x, (1, 1, 2, 0))
            F.conv2d(xp, w)
            dxp, _, _ = torch.ops.aten.convolution_backward(
                dc, xp, w, None, (1, 1), (0, 0), (1, 1), False, (0, 0), 1,
                mask)
            F.pad(dxp, (-1, -1, -2, 0))

        def folded():
            F.conv2d(x, w, None, 1, (2, 1))
            torch.ops.aten.convolution_backward(
                dcf, x, w, None, (1, 1), (2, 1), (1, 1), False, (0, 0), 1,
                mask)

        row = dict(layer=name, n=n, cin=cin, cout=cout, h=h,
                   pad_valid_ms=cuda_ms(torch, pad_valid, reps),
                   folded_ms=cuda_ms(torch, folded, reps))
        rows.append(row)
        for f in tot:
            tot[f] += row[f]
        print(f"    pad fold {name:<6} {n}x{cin}->{cout} at {h}x{h}: "
              f"F.pad + VALID {row['pad_valid_ms']:.3f} ms, folded "
              f"{row['folded_ms']:.3f} ms")
        del x, dc, dcf
    return dict(tot, layers=rows)


def conv_epilogue_row(torch, report, reps=10):
    """The conv epilogue's kernels line entry: forward and backward per
    batch-384 training step (12 launches each way: four rotations in a
    batch of 1536 64x64 images) and per 768x512 request (two trunk calls of
    2 images, 24 forward), against their bounds and twins; the pad fold's
    A/B at the step's shapes. Its launches are the main paths' own, read
    by ``read_counts`` ([4], [5], [7]-[9]) and filled in by ``main``."""
    n = 4 * TRAIN_BATCH
    step = time_epilogue(torch, [(n, l) for l in epilogue_layers(PATCH, PATCH)],
                         reps)
    kh, kw = KODAK
    request = time_epilogue(
        torch, [(2, l) for l in epilogue_layers(kh, kw) + epilogue_layers(kw, kh)],
        reps)
    for key, t in (("train_step", step), ("request", request)):
        print(f"  conv_epilogue per {key}: forward {t['fwd_ms']:.3f} ms "
              f"(bound {t['fwd_bound_ms']:.3f}, twin {t['fwd_plain_ms']:.3f}),"
              f" backward {t['bwd_ms']:.3f} ms (bound {t['bwd_bound_ms']:.3f},"
              f" twin {t['bwd_plain_ms']:.3f}), "
              f"{len(t['layers'])} launches each way")
    ab = pad_fold_ab(torch, n, reps)
    print(f"  pad fold per step: F.pad + VALID {ab['pad_valid_ms']:.3f} ms, "
          f"folded {ab['folded_ms']:.3f} ms")
    report["conv_epilogue"] = dict(train_step=step, request=request,
                                   pad_fold=ab)
    return dict(
        name="conv_epilogue", route="cuda",
        source="ssdn_tpu_torch/csrc/conv_epilogue.cu", replaces=None,
        ms=step["fwd_ms"] + step["bwd_ms"],
        plain_ms=step["fwd_plain_ms"] + step["bwd_plain_ms"],
        bound_ms=step["fwd_bound_ms"] + step["bwd_bound_ms"],
        bound_by="bytes", per=f"one batch-{TRAIN_BATCH} training step",
        dtype="bfloat16", per_request={f: request[f] for f in (
            "fwd_ms", "fwd_plain_ms", "fwd_bound_ms")})


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


# ------------------------------ the Trainer ------------------------------


class _Preempted(Exception):
    pass


def trainer_cfg(conv, head):
    """The flagship at full width (enc 48, dec 96, nin 384/96): RGB,
    Gaussian sigma 25 known, stabilized objective, bf16 trunk ("auto"),
    64x64 patches at batch 384, from random init (seed 0)."""
    from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style

    return TrainConfig(
        noise=parse_noise_style("gauss25"),
        model=ModelConfig(in_channels=3, conv_backend=conv, head_backend=head),
        patch_size=PATCH, batch_size=TRAIN_BATCH, iterations=TRAINER_STEPS,
        eval_interval=TRAINER_EVAL, snapshot_interval=TRAINER_EVAL, seed=0)


def trace_busy_ms(path):
    """(device busy ms, traced ms, top device events as (name, ms, count))
    of a torch.profiler chrome trace: busy is the union of the intervals of
    its device events (kernels, copies, memsets) over every stream (the
    prefetch copies run on streams of their own); traced is the span from
    its first event to its last, host or device."""
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and "dur" in e]
    traced = (max(e["ts"] + e["dur"] for e in spans)
              - min(e["ts"] for e in spans))
    events = [e for e in spans
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        name = e["name"].replace("void (anonymous namespace)::", "")[:60]
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                 key=lambda t: -t[1])[:10]
    return busy / 1e3, traced / 1e3, top


def trainer_rows(wd):
    with open(f"{wd}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return ({r["step"]: r for r in rows if r["prefix"] == "train"},
            [r for r in rows if r["prefix"] == "eval"])


def check_workdir(torch, wd, name, backend):
    import os

    for entry in ("config.json", "ckpt", "ckpt_best", "best_psnr.json",
                  "metrics.jsonl", "sampler_backend.json"):
        check(os.path.exists(f"{wd}/{entry}"), f"{name}: no {entry} in {wd}")
    with open(f"{wd}/sampler_backend.json") as f:
        recorded = json.load(f)["backend"]
    check(recorded == backend, f"{name}: sampler backend {recorded}, "
                               f"expected {backend}")
    train, evals = trainer_rows(wd)
    check(sorted(train) == list(range(TRAINER_LOG, TRAINER_STEPS + 1,
                                      TRAINER_LOG)),
          f"{name}: logged steps {sorted(train)}")
    losses = {s: r["loss"] for s, r in train.items()}
    check(all(np.isfinite(v) for v in losses.values()),
          f"{name}: non-finite loss {losses}")
    check(losses[TRAINER_STEPS] < losses[TRAINER_LOG],
          f"{name}: loss at step {TRAINER_STEPS} {losses[TRAINER_STEPS]:.4f} "
          f"not below step {TRAINER_LOG}'s {losses[TRAINER_LOG]:.4f}")
    # patches/s over the steps after TRAINER_EVAL, from the Trainer's own
    # log lines (each times its window on the host clock; the window after
    # an eval includes that eval and the snapshot)
    later = [s for s in train if s > TRAINER_EVAL]
    seconds = sum(TRAINER_LOG * TRAIN_BATCH / train[s]["patches_per_sec"]
                  for s in later)
    busy, traced, top = trace_busy_ms(f"{wd}/profile/trace.json")
    return dict(losses=losses, evals=[(r["step"], r["psnr"]) for r in evals],
                patches_per_s=len(later) * TRAINER_LOG * TRAIN_BATCH / seconds,
                patches_per_s_last=train[TRAINER_STEPS]["patches_per_sec"],
                busy_ms_per_step=busy / TRAINER_LOG,
                traced_ms_per_step=traced / TRAINER_LOG,
                # over the profiled window itself: the profiler's host
                # cost slows the host side, so this is an upper bound
                idle_share=1 - busy / traced,
                top_ms_per_step=[(k, ms / TRAINER_LOG, n) for k, ms, n in top],
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def sampler_rates():
    """The host samplers alone: patches/s of sample() called in turn, and
    through a Prefetcher with its default 4 threads (no device copy)."""
    from ssdn_tpu_torch.data import Prefetcher, open_dataset
    from ssdn_tpu_torch.native import make_sampler

    out = {}
    for name, spec, backend, n in (("native", "synthetic:64:128", "native", 20),
                                   ("streaming", "synthetic:inf:128", "auto", 10)):
        s = make_sampler(open_dataset(spec), PATCH, TRAIN_BATCH, seed=0,
                         backend=backend)
        s.sample(0)
        t0 = time.perf_counter()
        for i in range(n):
            s.sample(i)
        alone = n * TRAIN_BATCH / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in Prefetcher(s, 0, 2 * n):
            pass
        pre = 2 * n * TRAIN_BATCH / (time.perf_counter() - t0)
        out[name] = dict(sampler=type(s).__name__, patches_per_s=alone,
                         prefetched_patches_per_s=pre)
        getattr(s, "close", lambda: None)()
    return out


def run_trainer(torch, report, kept):
    """The Trainer path: the conv arm through ``cli.train.main`` (K1, the
    native sampler), the head arm through ``Trainer`` (K2' and K3 per step,
    K2 per eval; the streaming sampler), each TRAINER_STEPS steps with
    eval and snapshots, counts read around each; then exact resume (head
    arm, preempted after its step-20 snapshot) and ``cli.denoise
    --workdir`` on the conv arm's workdir, which stays (with the request
    it served, in ``kept``) for [8f]."""
    import shutil

    import ssdn_tpu_torch.infer as infer
    from ssdn_tpu_torch.cli.denoise import main as denoise_main
    from ssdn_tpu_torch.cli.train import main as train_main
    from ssdn_tpu_torch.train.loop import Trainer
    from ssdn_tpu_torch.train.step import init_state
    from ssdn_tpu_torch.utils import load_image, save_image

    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    n_eval = int(TRAINER_EVAL_DATA.split(":")[1])
    eval_forwards = (TRAINER_STEPS // TRAINER_EVAL) * -(-n_eval // 4)
    out, launches = {}, {}

    conv_wd = f"{TRAINER_DIR}/conv"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_main([
        "--workdir", conv_wd, "--device", DEVICE,
        "--train-data", "synthetic:64:128", "--eval-data", TRAINER_EVAL_DATA,
        "--sampler-backend", "native", "--conv-backend", "pallas",
        "--noise-style", "gauss25", "--patch-size", str(PATCH),
        "--batch-size", str(TRAIN_BATCH), "--iterations", str(TRAINER_STEPS),
        "--log-interval", str(TRAINER_LOG),
        "--eval-interval", str(TRAINER_EVAL),
        "--snapshot-interval", str(TRAINER_EVAL),
        "--profile-dir", f"{conv_wd}/profile"])
    launches["conv"] = read_counts()
    out["conv"] = dict(check_workdir(torch, conv_wd, "conv arm", "native"),
                       seconds=time.perf_counter() - t0)

    head_cfg = trainer_cfg("lax", "pallas")
    head_wd = f"{TRAINER_DIR}/head"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = Trainer(head_cfg, head_wd, train_data="synthetic:inf:128",
                   eval_data=TRAINER_EVAL_DATA, log_interval=TRAINER_LOG,
                   profile_dir=f"{head_wd}/profile", device=DEVICE).train()
    launches["head"] = read_counts()
    out["head"] = dict(check_workdir(torch, head_wd, "head arm", "python"),
                       seconds=time.perf_counter() - t0)

    want = {"conv": dict(k1=K1_PER_TRUNK * (TRAINER_STEPS + eval_forwards),
                         k2=0, k2_save_h1=0, k3=0,
                         **epi_counts("conv_pallas", TRAINER_STEPS,
                                      eval_forwards)),
            "head": dict(k1=0, k2=eval_forwards, k2_save_h1=TRAINER_STEPS,
                         k3=TRAINER_STEPS,
                         **epi_counts("head_pallas", TRAINER_STEPS,
                                      eval_forwards))}
    for arm, counts in launches.items():
        check(counts == want[arm], f"Trainer {arm} arm: launches {counts}, "
                                   f"expected {want[arm]}")

    # exact resume: preempted after the step-TRAINER_EVAL snapshot, then a
    # new Trainer on the same workdir trains on to the end
    cut_wd = f"{TRAINER_DIR}/head_resumed"
    tr = Trainer(head_cfg, cut_wd, train_data="synthetic:inf:128",
                 eval_data=TRAINER_EVAL_DATA, log_interval=TRAINER_LOG,
                 device=DEVICE)
    real = tr.step_fn

    def preempted(state, batch):
        if state.step == TRAINER_EVAL:
            raise _Preempted
        return real(state, batch)

    tr.step_fn = preempted
    try:
        tr.train()
        check(False, "the preempted run was not preempted")
    except _Preempted:
        pass
    check(tr.ckpt.latest_step() == TRAINER_EVAL,
          f"preempted run: latest checkpoint {tr.ckpt.latest_step()}")
    for fault in RESUME_FAULTS:
        shutil.copytree(cut_wd, f"{cut_wd}_{fault}")

    def resume(wd, fault=None):
        tr = Trainer(head_cfg, wd, train_data="synthetic:inf:128",
                     eval_data=TRAINER_EVAL_DATA, log_interval=TRAINER_LOG,
                     device=DEVICE)
        if fault == "opt_state_zeroed":
            restore = tr.ckpt.restore

            def zeroed(target):
                state = restore(target)
                for tree in state.opt_state.values():
                    for t in (v for d in tree.values() for v in d.values()):
                        t.zero_()
                return state

            tr.ckpt.restore = zeroed
        elif fault == "batches_from_step_0":
            sampler = tr.sampler
            tr.sampler = type("Restarted", (), dict(
                sample=lambda self, s: sampler.sample(s - TRAINER_EVAL)))()
        return tr.train()

    init = init_state(head_cfg, device=DEVICE).params
    keys = [(k, n) for k in full.params for n in full.params[k]]
    sq = lambda a, b: sum(float(torch.sum((a[k][n].float() - b[k][n].float())
                                          ** 2)) for k, n in keys)
    moved = sq(full.params, init) ** 0.5

    def against_full(state):
        gap = sq(state.params, full.params) ** 0.5
        return dict(
            step=state.step, gap_l2=gap, moved_l2=moved, ratio=gap / moved,
            max_abs=max(float((state.params[k][n] - full.params[k][n])
                              .abs().max()) for k, n in keys),
            bits_match=all(torch.equal(state.params[k][n], full.params[k][n])
                           for k, n in keys),
            bar=RESUME_BAR)

    rs = out["resume"] = against_full(resume(cut_wd))
    check(rs["step"] == TRAINER_STEPS, f"resumed to step {rs['step']}")
    check(rs["ratio"] <= RESUME_BAR,
          f"resumed params off the uninterrupted run's: |gap| "
          f"{rs['gap_l2']:.3g} > {RESUME_BAR} x |moved| {moved:.3g}")
    rs["faults"] = {}
    for fault in RESUME_FAULTS:
        f = rs["faults"][fault] = against_full(resume(f"{cut_wd}_{fault}",
                                                      fault))
        check(f["step"] == TRAINER_STEPS and f["ratio"] > RESUME_BAR,
              f"a resume with {fault} reads {f['ratio']:.3g} of the distance "
              f"moved, within the bar {RESUME_BAR}: the bar cannot tell it")

    # serving from the conv arm's workdir through cli.denoise
    clean = clean_image(700, *KODAK)
    noisy = clean + np.random.default_rng(701).normal(
        0, 25 / 255, clean.shape).astype(np.float32)
    save_image(f"{TRAINER_DIR}/in/kodak.png", noisy)
    got = []
    real_denoise = infer.denoise_image
    infer.denoise_image = lambda *a, **k: got.append(
        real_denoise(*a, **k)) or got[-1]
    reset_counts()
    try:
        denoise_main(["--workdir", conv_wd, "--input",
                      f"{TRAINER_DIR}/in/kodak.png", "--output",
                      f"{TRAINER_DIR}/out", "--device", DEVICE])
    finally:
        infer.denoise_image = real_denoise
    launches["denoise"] = read_counts()
    kept.update(conv_wd=conv_wd, request=f"{TRAINER_DIR}/in/kodak.png",
                served=got[0])
    written = load_image(f"{TRAINER_DIR}/out/kodak_denoised.png")
    check(len(got) == 1 and got[0].shape == (*KODAK, 3)
          and bool(np.isfinite(got[0]).all()),
          "cli.denoise --workdir: no finite 768x512 output")
    check(written.shape == (*KODAK, 3), f"denoised file {written.shape}")
    check(launches["denoise"]["k1"] == 2 * K1_PER_TRUNK
          and launches["denoise"]["epi"] == epi_per_forward("conv_pallas", 2),
          f"cli.denoise --workdir: launches {launches['denoise']}")

    out["samplers"] = sampler_rates()
    fixed = {r["arm"]: r["patches_per_s"] for r in report["training"]}
    for arm, key in (("conv", "conv_pallas"), ("head", "head_pallas")):
        r = out[arm]
        r["fixed_batch_patches_per_s"] = fixed[key]
        # the profiled steps' device time against the unprofiled steps'
        # host clock (as [6] does for the fixed batch)
        r["idle_share_unprofiled"] = 1 - r["busy_ms_per_step"] / (
            TRAIN_BATCH / r["patches_per_s_last"] * 1e3)
        print(f"  Trainer {arm} arm: {r['seconds']:.1f} s for "
              f"{TRAINER_STEPS} steps, loss {r['losses'][TRAINER_LOG]:.4f} "
              f"(step {TRAINER_LOG}) -> {r['losses'][TRAINER_STEPS]:.4f}; "
              f"{r['patches_per_s']:.1f} patches/s over steps "
              f"{TRAINER_EVAL}-{TRAINER_STEPS} ({r['patches_per_s_last']:.1f}"
              f" over the last {TRAINER_LOG}), fixed batch ([5]) "
              f"{fixed[key]:.1f}; device busy {r['busy_ms_per_step']:.2f} "
              f"of {r['traced_ms_per_step']:.2f} ms per step (profiled steps "
              f"{TRAINER_LOG}-{TRAINER_EVAL}), idle {r['idle_share']:.1%} "
              f"(against the unprofiled last {TRAINER_LOG}: "
              f"{r['idle_share_unprofiled']:.1%}); "
              f"peak {r['peak_gb']:.1f} GB; evals "
              f"{r['evals']}; top kernels (ms per step): "
              + ", ".join(f"{k[:40]} {ms:.2f}"
                          for k, ms, _ in r["top_ms_per_step"][:5]))
    rs = out["resume"]
    print(f"  resume at step {TRAINER_EVAL}: params |resumed - full| "
          f"{rs['gap_l2']:.3g} = {rs['ratio']:.3g} x |full - init| "
          f"{rs['moved_l2']:.3g} (bar {RESUME_BAR}), max abs "
          f"{rs['max_abs']:.3g}, bits match: {rs['bits_match']}; planted "
          "faults: " + ", ".join(f"{k} {f['ratio']:.3g}"
                                 for k, f in rs["faults"].items()))
    for name, r in out["samplers"].items():
        print(f"  host sampler {name} ({r['sampler']}, batch {TRAIN_BATCH}): "
              f"{r['patches_per_s']:.1f} patches/s alone, "
              f"{r['prefetched_patches_per_s']:.1f} through a 4-thread "
              "Prefetcher")
    print(f"  Trainer path launches: {launches}")
    report["trainer"] = out
    report["trainer_launches"] = launches
    return launches



# ------------------------- the tiled and aux paths -------------------------

TILED_DIR = "build/chip_smoke_tiled"   # under the checkout, gitignored


@functools.lru_cache(maxsize=None)
def tiled_image(h, w):
    """(clean, noisy at sigma 25) of TILED_HW, internal range; CAMERA_HW
    is the same image reflect-padded to the camera frame (only its noisy
    image is used: [8c] times and measures it)."""
    if (h, w) == CAMERA_HW:
        _, noisy = tiled_image(*TILED_HW)
        return None, np.pad(noisy, [(0, h - TILED_HW[0]),
                                    (0, w - TILED_HW[1]), (0, 0)], "reflect")
    clean = clean_image(800, h, w)
    noisy = clean + np.random.default_rng(801).normal(
        0, 25 / 255, clean.shape).astype(np.float32)
    return clean, noisy


def n_windows(w):
    """Windows of a sequential call on an image w columns wide."""
    pw = -(-w // 32) * 32   # stride-32 padded width
    return -(-pw // TILE_W)


def tiled_arms(torch, models, report):
    """[8a] fp32 ``gauss25_rgb`` and [8b] bf16 ``gauss5_50_blind_rgb``:
    ``tiled_denoise_sequential`` of a 2048x1536 image in each arm, counts
    set to 0 just before each call and read just after it. Every arm's
    tiled result against the lax arm's at [4]'s bar (fp32 1e-4, bf16
    4/255): these window shapes (1152x1536, rotated 1536x1152) are ones
    [4] never runs. fp32 also: each arm against its own ``denoise_image``
    at 1e-4, and each arm's full image against the lax arm's at 1e-4;
    bf16: the tiled-vs-full PSNR gap (the blind estimate is per window)
    reported. Returns the tiled path's launches."""
    from ssdn_tpu_torch.infer import full
    from ssdn_tpu_torch.infer.tiled import tiled_denoise_sequential
    from ssdn_tpu_torch.utils.images import psnr

    wins = n_windows(TILED_HW[1])
    clean, noisy = tiled_image(*TILED_HW)
    pv = sigma_vec(25.0)
    noisy_db = psnr(noisy, clean)
    launches, rows = {"k1": 0, "k2": 0, "epi": 0}, []
    for name in MODELS:
        cfg, params = models[name]
        bf16 = cfg.model.compute_dtype == "bfloat16"
        tol = 4 / 255 if bf16 else 1e-4   # [4]'s bars against the lax arm
        seqs, wholes = {}, {}
        for arm in ARMS:   # lax first: the others are held against it
            c = with_arm(cfg, arm)
            t0 = time.perf_counter()
            reset_counts()
            seq = seqs[arm] = tiled_denoise_sequential(
                c, params, noisy, pv, tile_w=TILE_W, halo=HALO)
            counts = read_counts()
            secs = time.perf_counter() - t0
            for k in launches:
                launches[k] += counts[k]
            # each window: one non-square forward (two trunk calls)
            want = {"lax": (0, 0), "head_pallas": (0, wins),
                    "conv_pallas": (2 * K1_PER_TRUNK * wins, 0)}[arm] + (
                        wins * epi_per_forward(arm, 2, bf16),)
            got = (counts["k1"], counts["k2"], counts["epi"])
            check(got == want, f"tiled {name}/{arm}: launches K1, K2, "
                               f"epilogue {got}, expected {want}")
            check(seq.shape == clean.shape and bool(np.isfinite(seq).all()),
                  f"tiled {name}/{arm}: shape {seq.shape} or not finite")
            row = dict(model=name, arm=arm, windows=wins, k1=got[0],
                       k2=got[1], seconds=secs, tol_vs_lax=tol,
                       psnr_gain_db=psnr(seq, clean) - noisy_db)
            check(row["psnr_gain_db"] >= 3.0, f"tiled {name}/{arm}: PSNR gain "
                                              f"{row['psnr_gain_db']:.2f} dB")
            d = row["max_abs_vs_lax"] = float(np.abs(seq - seqs["lax"]).max())
            check(d <= tol, f"tiled {name}/{arm}: differs from the lax arm's "
                            f"tiled result by {d:.3e} > {tol:.1e}")
            if not bf16 or arm == "lax":
                whole = wholes[arm] = full.denoise_image(
                    full.make_denoise_fn(c), params, noisy, pv)
                row.update(max_abs_vs_full=float(np.abs(seq - whole).max()),
                           bits_match_full=bool(np.array_equal(seq, whole)),
                           full_psnr_gain_db=psnr(whole, clean) - noisy_db)
            if not bf16:
                check(row["max_abs_vs_full"] <= 1e-4,
                      f"tiled {name}/{arm}: differs from the full image by "
                      f"{row['max_abs_vs_full']:.3e} > 1e-4")
                dw = row["full_max_abs_vs_lax"] = float(
                    np.abs(whole - wholes["lax"]).max())
                check(dw <= tol, f"full {name}/{arm}: differs from the lax "
                                 f"arm's full image by {dw:.3e} > {tol:.1e}")
            rows.append(row)
            extra = f"|arm - lax| {d:.2e}"
            if not bf16:
                extra += (f" (full image {row['full_max_abs_vs_lax']:.2e}), "
                          f"|tiled - full| {row['max_abs_vs_full']:.2e}, bits "
                          f"match: {row['bits_match_full']}")
            elif arm == "lax":
                extra += (f", tiled - full PSNR "
                          f"{row['psnr_gain_db'] - row['full_psnr_gain_db']:+.3f}"
                          " dB (per-window blind estimate)")
            print(f"  [8{'b' if bf16 else 'a'}] {name:<20} {arm:<12} "
                  f"{wins} windows, K1 {got[0]}, K2 {got[1]}, gain "
                  f"{row['psnr_gain_db']:.2f} dB, {extra} ({secs:.1f} s)")
    report["tiled"] = rows
    return launches


def tiled_memory(torch, models, report):
    """[8c] the head arm (the fastest fp32 arm), ``gauss25_rgb``: peak
    device memory and time per call (CUDA events around calls that end
    in the host copy) of the full image and sequential windows at
    2048x1536, and sequential windows at 4032x3024."""
    from ssdn_tpu_torch.infer import full
    from ssdn_tpu_torch.infer.tiled import tiled_denoise_sequential

    cfg, params = models["gauss25_rgb"]
    c = with_arm(cfg, "head_pallas")
    fn = full.make_denoise_fn(c)
    pv = sigma_vec(25.0)
    rows = []
    for mode, (h, w) in (("full", TILED_HW), ("sequential", TILED_HW),
                         ("sequential", CAMERA_HW)):
        y = tiled_image(h, w)[1]
        if mode == "full":
            call = lambda: full.denoise_image(fn, params, y, pv)
        else:
            call = lambda: tiled_denoise_sequential(c, params, y, pv,
                                                    tile_w=TILE_W, halo=HALO)
        call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, call, TILED_REPS)
        peak = torch.cuda.max_memory_allocated()
        rows.append(dict(mode=mode, size=f"{w}x{h}",
                         windows=n_windows(w) if mode != "full" else 1,
                         ms=ms, mp_per_s=h * w / 1e6 / (ms / 1e3),
                         peak_gb=peak / 1e9, peak_above_base_gb=(peak - base) / 1e9))
        r = rows[-1]
        print(f"  [8c] head_pallas fp32 {mode:<10} {r['size']:<9} "
              f"{r['windows']} window(s): {ms:8.1f} ms, {r['mp_per_s']:.2f} "
              f"MP/s, peak {r['peak_gb']:.2f} GB ({r['peak_above_base_gb']:.2f}"
              " above what was allocated before)")
    full_r, seq_r, cam_r = rows
    ratios = dict(
        seq_over_full_ms=seq_r["ms"] / full_r["ms"],
        seq_over_full_peak=seq_r["peak_above_base_gb"]
        / full_r["peak_above_base_gb"],
        camera_over_seq_peak=cam_r["peak_above_base_gb"]
        / seq_r["peak_above_base_gb"])
    print("  [8c] ratios: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in ratios.items()))
    report["tiled_memory"] = dict(rows=rows, ratios=ratios)


def tiled_cli(torch, models, report):
    """[8d] ``cli.denoise --pretrained gauss25_rgb --tiled sequential`` on a
    2048x1536 PNG against the library call in the artifact's recorded arm
    (lax/lax: no kernel launches): the same PNG bytes."""
    from ssdn_tpu_torch.cli.denoise import default_param
    from ssdn_tpu_torch.cli.denoise import main as denoise_main
    from ssdn_tpu_torch.cli.denoise import to_internal_param
    from ssdn_tpu_torch.infer.tiled import tiled_denoise_sequential
    from ssdn_tpu_torch.utils import load_image, save_image
    from ssdn_tpu_torch.utils.images import to_internal

    cfg, params = models["gauss25_rgb"]
    src = f"{TILED_DIR}/in/wide.png"
    save_image(src, tiled_image(*TILED_HW)[1])
    t0 = time.perf_counter()
    denoise_main(["--pretrained", "gauss25_rgb", "--input", src, "--output",
                  f"{TILED_DIR}/cli", "--tiled", "sequential", "--tile-w",
                  str(TILE_W), "--halo", str(HALO), "--device", DEVICE])
    secs = time.perf_counter() - t0
    lib = tiled_denoise_sequential(
        cfg, params, to_internal(load_image(src)),
        to_internal_param(cfg, default_param(cfg)), tile_w=TILE_W, halo=HALO)
    save_image(f"{TILED_DIR}/lib/wide_denoised.png", lib)
    with open(f"{TILED_DIR}/cli/wide_denoised.png", "rb") as a, \
            open(f"{TILED_DIR}/lib/wide_denoised.png", "rb") as b:
        same = a.read() == b.read()
    report["tiled_cli"] = dict(
        arm=f"{cfg.model.conv_backend}/{cfg.model.head_backend}",
        same_png_bytes=same, seconds=secs)
    print(f"  [8d] cli.denoise --pretrained gauss25_rgb --tiled sequential "
          f"(arm {report['tiled_cli']['arm']}): {secs:.1f} s, the library "
          f"call's PNG bytes: {same}")
    check(same, "cli.denoise --tiled sequential wrote other PNG bytes than "
                "the library call")


def calibration(torch, report):
    """[8e] ``tools.blind_calibration`` on ``gauss5_50_blind_rgb`` at its
    default values, in the artifact's recorded arm (lax/lax: no kernel
    launches): the estimates rise with the true value, every PSNR is
    finite; the table goes into the report."""
    import contextlib
    import io

    from ssdn_tpu_torch.tools import blind_calibration

    out = f"{TILED_DIR}/calibration.json"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        blind_calibration.main([
            "gauss5_50_blind_rgb", "--images", str(CAL_IMAGES), "--size",
            str(CAL_SIZE), "--device", DEVICE, "--json-out", out])
    secs = time.perf_counter() - t0
    with open(out) as f:
        rows = json.load(f)
    table = buf.getvalue()
    report["calibration"] = dict(rows=rows, table=table, seconds=secs)
    print(f"  [8e] blind_calibration gauss5_50_blind_rgb, {CAL_IMAGES} images "
          f"of {CAL_SIZE} px per value ({secs:.1f} s):")
    for line in table.splitlines():
        print(f"       {line}")
    ests = [r["est_mean"] for r in rows]
    check([r["true"] for r in rows] == [5, 15, 25, 40, 50],
          f"calibration values {[r['true'] for r in rows]}")
    check(all(b > a for a, b in zip(ests, ests[1:])),
          f"blind estimates do not rise with the true value: {ests}")
    check(all(np.isfinite(r["psnr"]) for r in rows),
          f"calibration PSNR not finite: {rows}")


def export_served(torch, kept, report):
    """[8f] ``tools.export_pretrained`` on [7]'s conv-arm workdir; the
    port's ``zoo.load`` of the artifact serves [7]'s 768x512 request
    through K1, bit for bit what ``cli.denoise --workdir`` served."""
    from ssdn_tpu_torch import zoo
    from ssdn_tpu_torch.cli.denoise import default_param, to_internal_param
    from ssdn_tpu_torch.infer import full
    from ssdn_tpu_torch.models.blindspot_unet import params_from_jax
    from ssdn_tpu_torch.tools import export_pretrained
    from ssdn_tpu_torch.utils import load_image
    from ssdn_tpu_torch.utils.images import to_internal

    npz = f"{TILED_DIR}/conv_arm.npz"
    export_pretrained.main([kept["conv_wd"], npz, "--device", DEVICE,
                            "--note", "chip_smoke [7] conv arm"])
    cfg, tree, meta = zoo.load(npz)
    params = params_from_jax(tree, device=DEVICE)
    reset_counts()
    got = full.denoise_image(full.make_denoise_fn(cfg), params,
                             to_internal(load_image(kept["request"])),
                             to_internal_param(cfg, default_param(cfg)))
    counts = read_counts()
    same = bool(np.array_equal(got, kept["served"]))
    report["export"] = dict(meta=meta, launches=counts, bits_match=same,
                            max_abs=float(np.abs(got - kept["served"]).max()))
    print(f"  [8f] export_pretrained of [7]'s conv-arm workdir (step "
          f"{meta['step']}): served 768x512 through K1 ({counts['k1']} "
          f"launches), bits of cli.denoise --workdir: {same}")
    check(counts["k1"] == 2 * K1_PER_TRUNK
          and counts["epi"] == epi_per_forward("conv_pallas", 2),
          f"exported model: launches {counts}")
    check(same, "the exported artifact serves another image than its "
                f"workdir: max abs {report['export']['max_abs']:.3e}")


def run_tiled(torch, models, kept, report):
    """[8]: the sub-steps in order; returns the tiled path's launches."""
    t0 = time.perf_counter()
    launches = tiled_arms(torch, models, report)
    tiled_memory(torch, models, report)
    tiled_cli(torch, models, report)
    calibration(torch, report)
    export_served(torch, kept, report)
    report["tiled_launches"] = launches
    report["tiled_seconds"] = time.perf_counter() - t0
    print(f"  tiled path launches: K1 {launches['k1']}, K2 {launches['k2']}, "
          f"conv epilogue {launches['epi']}; [8] took "
          f"{report['tiled_seconds']:.1f} s")
    return launches


# --------------- data parallelism and sharded tiling ([9]) ---------------

DIST_DIR = "build/chip_smoke_dist"     # under the checkout, gitignored
# DP training ([9a], [9b]): the flagship at batch 384, DP_STEPS steps per
# arm, logged every DP_LOG (no eval: every launch is a training step's)
DP_STEPS, DP_LOG = 15, 5
DIST_TIMEOUT = 420    # seconds per launched world (its ranks together)
PERLEVEL_PROBES = 3   # instrumented per-level calls timing the messages
ONE_CARD = "cuda:0"   # the device every rank of a gloo world shares


def dp_cli_argv(wd):
    """``cli.train``'s flags of the DP conv-arm run ([7]'s flagship, no
    eval)."""
    return ["--workdir", wd, "--device", DEVICE,
            "--train-data", "synthetic:64:128", "--sampler-backend", "native",
            "--conv-backend", "pallas", "--noise-style", "gauss25",
            "--patch-size", str(PATCH), "--batch-size", str(TRAIN_BATCH),
            "--iterations", str(DP_STEPS), "--log-interval", str(DP_LOG),
            "--eval-interval", "0", "--snapshot-interval", str(DP_STEPS)]


def dp_head_cfg():
    """The head arm's flagship config of the DP runs (``cli.train`` has no
    head-backend flag, so this arm runs through ``Trainer``)."""
    return dataclasses.replace(trainer_cfg("lax", "pallas"),
                               iterations=DP_STEPS, eval_interval=0,
                               snapshot_interval=DP_STEPS)


def _rank_json(root, rank, payload):
    with open(f"{root}/rank{rank}.json", "w") as f:
        json.dump(payload, f, default=str)


def _time_mean_grads(torch, params, group, reps=20):
    """ms per ``mean_grads_`` of a gradient tree shaped like ``params``
    (CUDA events), and its bytes."""
    from ssdn_tpu_torch.parallel import mean_grads_

    grads = {k: {n: torch.randn_like(t) for n, t in leaf.items()}
             for k, leaf in params.items()}
    nbytes = sum(t.numel() * t.element_size() for leaf in grads.values()
                 for t in leaf.values())
    return cuda_ms(torch, lambda: mean_grads_(grads, group), reps), nbytes


def worker_dp(spec):
    """One rank of a DP training run ([9a] / [9b] / [9e]), or the single
    process it is held to (spec["mode"] "one"): the head arm through
    ``Trainer``, then the conv arm through ``cli.train`` (with
    ``--data-parallel`` it joins the group formed here, and leaves it at
    its end; over gloo, whose ranks share cuda:0, through ``Trainer`` with
    the CLI's config), launches counted around each arm. The group is
    formed once: a default group re-formed on a store that still holds
    the last one's keys is not safe above world size 1. cuDNN runs its
    deterministic algorithms here: its default backward need not repeat
    its bits from run to run, which [9a]'s comparison would read."""
    import torch

    torch.backends.cudnn.deterministic = True

    from ssdn_tpu_torch import parallel
    from ssdn_tpu_torch.cli.train import build_parser, config_from_args
    from ssdn_tpu_torch.cli.train import main as train_main
    from ssdn_tpu_torch.train.loop import Trainer
    from ssdn_tpu_torch.train.step import init_state, make_train_step

    root, mode, backend = spec["root"], spec["mode"], spec.get("backend")
    group = None
    if mode == "dp":
        # several ranks on one card over gloo: NCCL refuses that
        group = (parallel.init_group(ONE_CARD, "gloo")
                 if backend == "gloo" else parallel.init_group(DEVICE))
    rank = group.rank if group is not None else 0
    out = {"mode": mode, "arms": {}}
    if group is not None:
        out.update(rank=group.rank, world=group.world, backend=group.backend)
    for arm in ("head", "conv"):
        wd = f"{root}/{arm}"
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        if arm == "conv" and backend != "gloo":
            train_main(dp_cli_argv(wd)
                       + (["--data-parallel"] if group is not None else []))
        else:
            cfg = (config_from_args(build_parser().parse_args(
                dp_cli_argv(wd))) if arm == "conv" else dp_head_cfg())
            Trainer(cfg, wd, train_data="synthetic:64:128",
                    log_interval=DP_LOG,
                    sampler_backend="native" if arm == "conv" else "python",
                    device=DEVICE if group is None else None,
                    group=group).train()
        torch.cuda.synchronize()
        out["arms"][arm] = dict(counts=read_counts(),
                                seconds=time.perf_counter() - t0)
        if arm == "head" and group is not None:
            # the gradient all-reduce alone, and the global batch's noise
            state = init_state(dp_head_cfg(), device=group.device)
            ms, nbytes = _time_mean_grads(torch, state.params, group)
            ts = make_train_step(dp_head_cfg(), device=group.device,
                                 group=group)
            batch = train_batch_u8()
            out.update(mean_grads_ms=ms, mean_grads_bytes=nbytes,
                       global_noise_ms=cuda_ms(
                           torch, lambda: ts.noisy_batch(batch, 0), 10))
    if backend == "gloo":
        parallel.destroy_group()
    _rank_json(root, rank, out)


def _perlevel_messages(torch, cfg, params, noisy, pv, group):
    """Messages, bytes and ms spent in ``ppermute`` (synchronised around
    each) over one instrumented per-level call."""
    from ssdn_tpu_torch.infer import halo
    from ssdn_tpu_torch.infer.halo import tiled_denoise_perlevel

    real, seen = halo.ppermute, []

    def timed(t, pairs, g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = real(t, pairs, g)
        torch.cuda.synchronize()
        seen.append((t.numel() * t.element_size(), time.perf_counter() - t0))
        return r

    halo.ppermute = timed
    try:
        tiled_denoise_perlevel(cfg, params, noisy, pv, group)
    finally:
        halo.ppermute = real
    return dict(messages=len(seen), bytes=sum(b for b, _ in seen),
                max_bytes=max(b for b, _ in seen),
                ms=1e3 * sum(s for _, s in seen))


def worker_sharded(spec):
    """One rank of sharded tiling ([9c] / [9e]; at world size 1 also
    [9d]'s CLIs): the 2048x1536 image of [8] in every arm of both models
    by strategy "window", the lax arm by "perlevel", and [4]'s first
    768x512 request by "window" (gather mode at world size 2: strip 384 <
    2 x 320), launches counted around each call; rank 0 saves every output
    for the checks in the parent, every rank its outputs' hashes."""
    import hashlib

    import torch

    from ssdn_tpu_torch import parallel
    from ssdn_tpu_torch.infer.tiled import tiled_denoise_sharded

    root, backend = spec["root"], spec.get("backend")
    out = {"calls": []}
    if spec.get("clis"):
        out["clis"] = sharded_clis(root)
    group = (parallel.init_group(ONE_CARD, "gloo") if backend == "gloo"
             else parallel.init_group(DEVICE))
    models = {name: load_model(name, group.device) for name in MODELS}
    pv = sigma_vec(25.0)
    images = {"wide": tiled_image(*TILED_HW)[1],
              "gather": requests(models[MODELS[0]][0])[0][1]}
    cases = [(name, arm, "window", "wide") for name in MODELS
             for arm in ARMS]
    cases += [(name, "lax", "perlevel", "wide") for name in MODELS]
    cases += [(name, arm, "window", "gather") for name in MODELS
              for arm in ARMS]
    for name, arm, strategy, img in cases:
        cfg, params = models[name]
        c = with_arm(cfg, arm)
        tiled_denoise_sharded(c, params, images[img], pv, group,
                              strategy=strategy)   # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        den = tiled_denoise_sharded(c, params, images[img], pv, group,
                                    strategy=strategy)
        secs = time.perf_counter() - t0
        key = f"{name}.{arm}.{strategy}.{img}"
        out["calls"].append(dict(
            key=key, counts=read_counts(), seconds=secs,
            sha256=hashlib.sha256(den.tobytes()).hexdigest()))
        if group.rank == 0:
            np.save(f"{root}/{key}.npy", den)
    cfg, params = models[MODELS[1]]
    out["perlevel_messages"] = [
        _perlevel_messages(torch, cfg, params, images["wide"], pv, group)
        for _ in range(PERLEVEL_PROBES)]
    out.update(rank=group.rank, world=group.world, backend=group.backend)
    _rank_json(root, group.rank, out)
    parallel.destroy_group()


def sharded_clis(root):
    """[9d] at world size 1: ``cli.denoise --pretrained gauss25_rgb --tiled
    sharded`` on the 2048x1536 PNG and ``cli.evaluate --data-parallel
    --save-images`` on ``synthetic:2:512``, each against the library call
    (``tiled_denoise_sharded``; ``evaluate_dataset`` over the group) in the
    artifact's recorded arm: the same PNG bytes. Each CLI forms and leaves
    its own group; the library calls run in one formed after them."""
    from ssdn_tpu_torch import parallel
    from ssdn_tpu_torch.cli.denoise import default_param, to_internal_param
    from ssdn_tpu_torch.cli.denoise import main as denoise_main
    from ssdn_tpu_torch.cli.evaluate import main as eval_main
    from ssdn_tpu_torch.data import open_dataset
    from ssdn_tpu_torch.infer import evaluate_dataset
    from ssdn_tpu_torch.infer.tiled import tiled_denoise_sharded
    from ssdn_tpu_torch.utils import load_image, save_image
    from ssdn_tpu_torch.utils.images import to_internal

    src = f"{root}/in/wide.png"
    save_image(src, tiled_image(*TILED_HW)[1])
    t0 = time.perf_counter()
    denoise_main(["--pretrained", "gauss25_rgb", "--input", src, "--output",
                  f"{root}/cli", "--tiled", "sharded", "--device", DEVICE])
    denoise_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eval_main(["--pretrained", "gauss25_rgb", "--dataset", "synthetic:2:512",
               "--data-parallel", "--save-images", f"{root}/eval_cli",
               "--json-out", f"{root}/eval_cli.json", "--device", DEVICE])
    eval_s = time.perf_counter() - t0
    group = parallel.init_group(DEVICE)
    cfg, params = load_model("gauss25_rgb", group.device)
    lib = tiled_denoise_sharded(cfg, params, to_internal(load_image(src)),
                                to_internal_param(cfg, default_param(cfg)),
                                group)
    save_image(f"{root}/lib/wide_denoised.png", lib)
    res = evaluate_dataset(cfg, params, open_dataset("synthetic:2:512"),
                           return_images=2, group=group)
    for i, trio in enumerate(res["images"]):
        save_image(f"{root}/eval_lib/{i:03d}_denoised.png", trio["denoised"])
    parallel.destroy_group()

    def same(a, b):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            return fa.read() == fb.read()

    with open(f"{root}/eval_cli.json") as f:
        cli_psnr = json.load(f)["psnr_per_image"]
    return dict(
        denoise_same_png=same(f"{root}/cli/wide_denoised.png",
                              f"{root}/lib/wide_denoised.png"),
        evaluate_same_png=all(same(f"{root}/eval_cli/{i:03d}_denoised.png",
                                   f"{root}/eval_lib/{i:03d}_denoised.png")
                              for i in range(2)),
        evaluate_same_psnr=cli_psnr == res["psnr_per_image"],
        psnr=cli_psnr, denoise_s=denoise_s, evaluate_s=eval_s)


def launch_world(kind, root, world, backend=None, clis=False):
    """Run ``python3 chip_smoke.py --worker KIND`` under ``torchrun
    --standalone`` with ``world`` ranks (kind "one": a plain process), its
    output in ``root``/log.txt; fails the phase on any rank's failure.
    Returns every rank's JSON."""
    import os

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    spec = json.dumps(dict(root=root, mode=kind, backend=backend, clis=clis))
    worker = "dp" if kind in ("dp", "one") else kind
    cmd = [sys.executable, __file__, "--worker", worker, "--spec", spec]
    if kind != "one":
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(world), *cmd[1:]]
    env = dict(os.environ, OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    with open(f"{root}/log.txt", "w") as log:
        try:
            run = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                 env=env, timeout=DIST_TIMEOUT)
            rc = run.returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    secs = time.perf_counter() - t0
    if rc != 0:
        with open(f"{root}/log.txt") as f:
            tail = f.read()[-4000:]
        check(False, f"[9] {kind} x{world} ({backend or 'default'}) exited "
                     f"with {rc}:\n{tail}")
    ranks = []
    for r in range(world if kind != "one" else 1):
        with open(f"{root}/rank{r}.json") as f:
            ranks.append(json.load(f))
    ranks[0]["launch_seconds"] = secs
    return ranks


def _ckpt_params(torch, wd):
    blob = torch.load(f"{wd}/ckpt/step_{DP_STEPS:010d}.pt",
                      map_location="cpu", weights_only=True)
    return blob["params"]


def _dp_compare(torch, got_wd, ref_wd, init):
    """The DP run's final params and logged losses against the single
    process's: the L2 gap over the L2 distance moved (RESUME_BAR), the
    bits, the least per-leaf cosine of the two updates and the largest
    relative loss gap (``_agreement_ok``'s bf16 bar)."""
    got, ref = _ckpt_params(torch, got_wd), _ckpt_params(torch, ref_wd)
    keys = [(k, n) for k in ref for n in ref[k]]
    sq = lambda a, b: sum(float(torch.sum((a[k][n].double()
                                           - b[k][n].double()) ** 2))
                          for k, n in keys)
    moved = sq(ref, init) ** 0.5
    cos = []
    for k, n in keys:
        a = (got[k][n] - init[k][n]).double().flatten()
        b = (ref[k][n] - init[k][n]).double().flatten()
        if b.abs().max() > 0:
            cos.append(float(torch.nn.functional.cosine_similarity(
                a, b, dim=0)))
    loss = {d: trainer_rows(wd)[0] for d, wd in (("got", got_wd),
                                                  ("ref", ref_wd))}
    check(sorted(loss["got"]) == sorted(loss["ref"]),
          f"DP logged steps {sorted(loss['got'])} vs {sorted(loss['ref'])}")
    return dict(
        ratio=sq(got, ref) ** 0.5 / moved, moved_l2=moved,
        bits_match=all(torch.equal(got[k][n], ref[k][n]) for k, n in keys),
        min_cos=min(cos),
        loss_rel=max(abs(loss["got"][s]["loss"] - loss["ref"][s]["loss"])
                     / abs(loss["ref"][s]["loss"]) for s in loss["ref"]),
        patches_per_s=loss["got"][max(loss["got"])]["patches_per_sec"],
        ref_patches_per_s=loss["ref"][max(loss["ref"])]["patches_per_sec"])


def dp_training(torch, report):
    """[9a] DP at world size 1 (NCCL, torchrun, ``cli.train
    --data-parallel`` in the conv arm, ``Trainer(group=)`` in the head
    arm) against the same runs without a group, at RESUME_BAR; [9b] world
    size 2 over gloo, both ranks on cuda:0, and [9e] world size
    ``device_count`` over NCCL where the machine has more cards, at
    ``_agreement_ok``'s bf16 bar. Launches counted in each rank around each arm: K1 12 per
    step (conv), K2' and K3 1 per step (head). Returns the launches."""
    from ssdn_tpu_torch.cli.train import build_parser, config_from_args
    from ssdn_tpu_torch.train.step import init_state

    one = launch_world("one", f"{DIST_DIR}/dp_one", 1)
    worlds = dist_worlds(torch, [("9a", 1, None), ("9b", 2, "gloo")])
    inits = {
        "conv": init_state(config_from_args(build_parser().parse_args(
            dp_cli_argv("x"))), device="cpu").params,
        "head": init_state(dp_head_cfg(), device="cpu").params}
    want = {"conv": dict(k1=K1_PER_TRUNK * DP_STEPS, k2=0, k2_save_h1=0, k3=0,
                         **epi_counts("conv_pallas", DP_STEPS)),
            "head": dict(k1=0, k2=0, k2_save_h1=DP_STEPS, k3=DP_STEPS,
                         **epi_counts("head_pallas", DP_STEPS))}
    for arm, counts in one[0]["arms"].items():
        check(counts["counts"] == want[arm],
              f"[9] single-process {arm} arm: launches {counts['counts']}")
    launches = {"k1": 0, "k2": 0, "k2_save_h1": 0, "k3": 0, "epi": 0,
                "epi_bwd": 0}
    rows = []
    for tag, world, backend in worlds:
        root = f"{DIST_DIR}/dp_{tag}"
        ranks = launch_world("dp", root, world, backend)
        for r in ranks:
            for arm, a in r["arms"].items():
                check(a["counts"] == want[arm],
                      f"[{tag}] rank {r['rank']} {arm} arm: launches "
                      f"{a['counts']}, expected {want[arm]}")
                for k in launches:
                    launches[k] += a["counts"][k]
        for arm in ("conv", "head"):
            c = _dp_compare(torch, f"{root}/{arm}", f"{DIST_DIR}/dp_one/{arm}",
                            inits[arm])
            if world > 1:   # the rows' sums split over the ranks
                ok = _agreement_ok("bfloat16", f"{arm}_pallas", "lax",
                                   "random", c)
                bar = "loss 1e-2, cosine 0.99"
            else:
                ok = c["ratio"] <= RESUME_BAR
                bar = f"|gap| <= {RESUME_BAR} |moved|"
            row = dict(path=tag, world=world, backend=ranks[0]["backend"],
                       arm=arm, seconds=ranks[0]["arms"][arm]["seconds"],
                       one_seconds=one[0]["arms"][arm]["seconds"],
                       mean_grads_ms=ranks[0]["mean_grads_ms"],
                       mean_grads_bytes=ranks[0]["mean_grads_bytes"],
                       global_noise_ms=ranks[0]["global_noise_ms"], **c)
            rows.append(row)
            shared = (" (2 processes sharing one card: no scaling number)"
                      if backend == "gloo" else "")
            print(f"  [{tag}] DP x{world} {row['backend']} {arm} arm: "
                  f"|dp - one| {c['ratio']:.3g} x |moved| {c['moved_l2']:.3g},"
                  f" bits match: {c['bits_match']}, update cosine "
                  f"{c['min_cos']:.6f}, loss gap {c['loss_rel']:.2e} "
                  f"(bar: {bar}); {c['patches_per_s']:.1f} patches/s over "
                  f"the last {DP_LOG} steps{shared}, one process "
                  f"{c['ref_patches_per_s']:.1f}")
            check(ok, f"[{tag}] DP {arm} arm off the single process: {c}")
        r0 = ranks[0]
        print(f"  [{tag}] mean_grads_ ({r0['mean_grads_bytes'] / 1e6:.2f} MB "
              f"of gradients, {r0['backend']}): {r0['mean_grads_ms']:.3f} ms;"
              f" the global batch's noise: {r0['global_noise_ms']:.3f} ms")
    report["dp_training"] = dict(rows=rows, launches=launches,
                                 one_seconds={a: v["seconds"] for a, v in
                                              one[0]["arms"].items()})
    return launches


def sharded_tiling(torch, models, report):
    """[9c] sharded tiling at world size 1 (NCCL, with [9d]'s CLIs) and 2
    (gloo on cuda:0), [9e] at ``device_count`` (NCCL) where there are more
    cards: every rank returns the same image; fp32 kernel arms held to the
    lax arm's sharded output and to the untiled image at 1e-4, the fp32
    per-level output to the untiled image at 1e-4, bf16 arms to the lax
    arm's sharded output at [4]'s bar and the bf16 blind per-level output
    (a global estimate) to the untiled image at that bar; K1 24 and K2 1
    launches per window in each rank. Returns the launches."""
    from ssdn_tpu_torch.infer import full
    from ssdn_tpu_torch.utils.images import psnr

    pv = sigma_vec(25.0)
    clean, noisy = tiled_image(*TILED_HW)
    gclean, gnoisy, _ = requests(models[MODELS[0]][0])[0]
    untiled = {}
    for name in MODELS:
        cfg, params = models[name]
        for img, y in (("wide", noisy), ("gather", gnoisy)):
            untiled[name, img] = full.denoise_image(
                full.make_denoise_fn(with_arm(cfg, "lax"), device=DEVICE),
                params, y, pv)
    torch.cuda.empty_cache()   # the ranks are processes of their own
    worlds = dist_worlds(torch, [("9c", 1, None), ("9c", 2, "gloo")])
    launches, rows, messages = {"k1": 0, "k2": 0, "epi": 0}, [], {}
    for tag, world, backend in worlds:
        root = f"{DIST_DIR}/sharded_{world}_{backend or 'nccl'}"
        ranks = launch_world("sharded", root, world, backend,
                             clis=world == 1)
        if world == 1:
            cl = ranks[0]["clis"]
            report["sharded_clis"] = cl
            print(f"  [9d] cli.denoise --tiled sharded: {cl['denoise_s']:.1f}"
                  f" s, the library call's PNG bytes: {cl['denoise_same_png']};"
                  f" cli.evaluate --data-parallel ({cl['evaluate_s']:.1f} s, "
                  f"PSNR {cl['psnr']}): the library's PNG bytes "
                  f"{cl['evaluate_same_png']}, PSNRs {cl['evaluate_same_psnr']}")
            check(cl["denoise_same_png"] and cl["evaluate_same_png"]
                  and cl["evaluate_same_psnr"],
                  f"[9d] a sharded CLI wrote other bytes than the library: {cl}")
        messages[f"{world}_{ranks[0]['backend']}"] = ranks[0][
            "perlevel_messages"]
        outs = {}
        for i, call in enumerate(ranks[0]["calls"]):
            key = call["key"]
            name, arm, strategy, img = key.split(".")
            for r in ranks:
                rc = r["calls"][i]
                check(rc["key"] == key and rc["sha256"] == call["sha256"],
                      f"[{tag}] x{world}: rank {r['rank']}'s {key} differs "
                      "from rank 0's")
                wins = 1 if strategy == "window" else 0
                want = {"lax": (0, 0), "head_pallas": (0, wins),
                        "conv_pallas": (2 * K1_PER_TRUNK * wins, 0)}[arm]
                got = (rc["counts"]["k1"], rc["counts"]["k2"])
                check(got == want, f"[{tag}] x{world} rank {r['rank']} {key}:"
                                   f" launches K1, K2 {got}, expected {want}")
                launches["k1"] += got[0]
                launches["k2"] += got[1]
                launches["epi"] += rc["counts"]["epi"]   # recorded only
            outs[key] = np.load(f"{root}/{key}.npy")
        for i, call in enumerate(ranks[0]["calls"]):
            key = call["key"]
            name, arm, strategy, img = key.split(".")
            cfg = models[name][0]
            bf16 = cfg.model.compute_dtype == "bfloat16"
            tol = 4 / 255 if bf16 else 1e-4
            out = outs[key]
            ref_clean = clean if img == "wide" else gclean
            ref_noisy = noisy if img == "wide" else gnoisy
            lax = outs[f"{name}.lax.window.{img}"]
            whole = untiled[name, img]
            row = dict(path=tag, world=world, backend=ranks[0]["backend"],
                       key=key, seconds=call["seconds"],
                       max_abs_vs_lax=float(np.abs(out - lax).max()),
                       max_abs_vs_untiled=float(np.abs(out - whole).max()),
                       bits_match_untiled=bool(np.array_equal(out, whole)),
                       psnr_gain_db=psnr(out, ref_clean)
                       - psnr(ref_noisy, ref_clean))
            rows.append(row)
            check(out.shape == ref_clean.shape
                  and bool(np.isfinite(out).all()),
                  f"[{tag}] x{world} {key}: shape {out.shape} or not finite")
            check(row["psnr_gain_db"] >= 3.0,
                  f"[{tag}] x{world} {key}: PSNR gain {row['psnr_gain_db']:.2f}")
            check(row["max_abs_vs_lax"] <= tol,
                  f"[{tag}] x{world} {key}: {row['max_abs_vs_lax']:.3e} from "
                  f"the lax arm's sharded output > {tol:.1e}")
            if not bf16 or strategy == "perlevel":
                check(row["max_abs_vs_untiled"] <= tol,
                      f"[{tag}] x{world} {key}: {row['max_abs_vs_untiled']:.3e}"
                      f" from the untiled image > {tol:.1e}")
            shared = (" (2 processes sharing one card)"
                      if backend == "gloo" else "")
            print(f"  [{tag}] x{world} {row['backend']} {key}: "
                  f"{call['seconds']:.2f} s{shared}, K1 {call['counts']['k1']}"
                  f", K2 {call['counts']['k2']} per rank, |- lax| "
                  f"{row['max_abs_vs_lax']:.2e}, |- untiled| "
                  f"{row['max_abs_vs_untiled']:.2e} (bits "
                  f"{row['bits_match_untiled']}), gain "
                  f"{row['psnr_gain_db']:.2f} dB")
        m = messages[f"{world}_{ranks[0]['backend']}"]
        print(f"  [{tag}] x{world} per-level messages ({MODELS[1]}, "
              f"{TILED_HW[1]}x{TILED_HW[0]}): {m[-1]['messages']} ppermutes, "
              f"{m[-1]['bytes'] / 1e6:.2f} MB (largest "
              f"{m[-1]['max_bytes'] / 1e3:.1f} KB), "
              + ", ".join(f"{p['ms']:.1f}" for p in m)
              + " ms in ppermute over the probes")
    report["sharded"] = dict(rows=rows, launches=launches,
                             perlevel_messages=messages)
    return launches


def dist_worlds(torch, one_card):
    """The worlds of a [9] sub-step: ``one_card``'s, then [9e] over NCCL at
    the machine's card count where it has more than one."""
    n = torch.cuda.device_count()
    return one_card + ([("9e", n, None)] if n > 1 else [])


def run_dist(torch, models, report):
    """[9]: the sub-steps in order; returns {path: launches}."""
    t0 = time.perf_counter()
    out = {"dp_training": dp_training(torch, report),
           "sharded": sharded_tiling(torch, models, report)}
    report["dist_seconds"] = time.perf_counter() - t0
    print(f"  [9] took {report['dist_seconds']:.1f} s; launches: {out}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--report", default=None,
                   help="write every measurement to this JSON file")
    p.add_argument("--worker", choices=["dp", "sharded"], default=None,
                   help=argparse.SUPPRESS)   # one rank of [9], launched by it
    p.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch

    if args.worker:
        spec = json.loads(args.spec)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        {"dp": worker_dp, "sharded": worker_sharded}[args.worker](spec)
        return 0
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

    models = {name: load_model(name, DEVICE) for name in MODELS}
    print("[3] kernels vs twins")
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
    epilogue_entry = conv_epilogue_row(torch, report)
    del calls
    torch.cuda.empty_cache()

    print(f"[7] main path, the Trainer: {TRAINER_STEPS} steps x 2 arms at "
          f"batch {TRAIN_BATCH} (eval, snapshots), resume, cli.denoise "
          "--workdir")
    kept = {}
    trainer = run_trainer(torch, report, kept)
    check(all(trainer[arm][k] > 0 for arm, ks in (
        ("conv", ("k1",)), ("head", ("k2", "k2_save_h1", "k3"))) for k in ks),
        f"a kernel was not launched on the Trainer path: {trainer}")
    by_name = {"shifted_conv3x3_bias_act": ("k1", "conv", "serving"),
               "fused_nin_head": ("k2", "head", "serving"),
               "nin_head_fwd(save_h1=True)": ("k2_save_h1", "head", "training"),
               "nin_head_bwd": ("k3", "head", "training")}
    for entry in kernel_line:
        count, arm, first = by_name[entry["name"]]
        entry["launches_by_path"] = {first: entry["launches"],
                                     "trainer": trainer[arm][count]}
        entry["launches"] += trainer[arm][count]
        if entry["name"] == "shifted_conv3x3_bias_act":
            entry["launches"] += train_launches["k1"]
            entry["launches_by_path"].update(
                training=train_launches["k1"],
                reference_training_fp32=report["reference_train_launches"][
                    "conv_pallas"]["k1"])
            for key, dt in (("per_train_step", "bfloat16"),
                            ("per_train_step_fp32", "float32")):
                t = next(v for (k, _), v in train_timing.items()
                         if k == "k1t" and v["dtype"] == dt)
                entry[key] = {f: t[f] for f in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "launches_per_step")}

    print(f"[8] the tiled and aux paths: sequential windows of {TILE_W} + 2 x "
          f"{HALO} columns (2048x1536, 3 arms x 2 models; 4032x3024), "
          "cli.denoise --tiled sequential, blind_calibration, "
          "export_pretrained")
    tiled = run_tiled(torch, models, kept, report)
    check(tiled["k1"] > 0 and tiled["k2"] > 0,
          f"a kernel was not launched on the tiled path: {tiled}")
    for entry in kernel_line:
        kind = {"shifted_conv3x3_bias_act": "k1",
                "fused_nin_head": "k2"}.get(entry["name"])
        if kind:
            entry["launches_by_path"]["tiled"] = tiled[kind]
            entry["launches"] += tiled[kind]
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    shutil.rmtree(TILED_DIR, ignore_errors=True)
    torch.cuda.empty_cache()   # [9]'s ranks are processes of their own

    print(f"[9] data parallelism and sharded tiling: DP training x1 (NCCL) "
          f"and x2 (gloo on one card), {DP_STEPS} steps x 2 arms at batch "
          f"{TRAIN_BATCH}; sharded tiling x1 and x2 (2048x1536, 3 arms x 2 "
          "models, per-level, gather at 768x512); the sharded CLIs")
    dist = run_dist(torch, models, report)
    check(all(dist["dp_training"][k] > 0 for k in ("k1", "k2_save_h1", "k3"))
          and all(dist["sharded"][k] > 0 for k in ("k1", "k2")),
          f"a kernel was not launched on the [9] paths: {dist}")
    for entry in kernel_line:
        kind = {"shifted_conv3x3_bias_act": "k1", "fused_nin_head": "k2",
                "nin_head_fwd(save_h1=True)": "k2_save_h1",
                "nin_head_bwd": "k3"}[entry["name"]]
        for path, counts in dist.items():
            entry["launches_by_path"][path] = counts.get(kind, 0)
            entry["launches"] += counts.get(kind, 0)
    shutil.rmtree(DIST_DIR, ignore_errors=True)

    # the epilogue's launches on each main path, forward and backward
    per_path = {
        "serving": report["main_path_launches"]["epi"],
        "training": (train_launches["epi"], train_launches["epi_bwd"]),
        "reference_training_fp32": sum(
            c["epi"] + c["epi_bwd"]
            for c in report["reference_train_launches"].values()),
        "trainer": tuple(trainer["conv"][k] + trainer["head"][k]
                         for k in ("epi", "epi_bwd")),
        "tiled": tiled["epi"],
        "dp_training": (dist["dp_training"]["epi"],
                        dist["dp_training"]["epi_bwd"]),
        "sharded": dist["sharded"]["epi"]}
    check(all(per_path[k] for k in ("serving", "training", "trainer", "tiled",
                                    "dp_training"))
          and per_path["reference_training_fp32"] == 0,
          f"the conv epilogue did not launch on a bf16 path, or launched in "
          f"fp32: {per_path}")
    epilogue_entry["launches_by_path"] = per_path
    epilogue_entry["launches"] = sum(
        sum(v) if isinstance(v, tuple) else v for v in per_path.values())
    report["conv_epilogue"]["launches_by_path"] = per_path
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    kernel_line.append(epilogue_entry)
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
