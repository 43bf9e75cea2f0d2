#!/usr/bin/env python3
"""K1 (the shifted 3x3 conv + bias + LeakyReLU) alone on one NVIDIA GPU,
layer by layer.

    python3 k1_probe.py [--reps N] [--fp32] [--host] [--against DIR]
                        [--out PATH]

On random operands (made on the card from a seed) at the 12 layer shapes
of a batch-384 training step (the four rotations folded into batch 1536,
64x64 patches) and the 24 of a 768x512 request (two trunk calls of batch
2, at 512x768 and 768x512), prints per layer K1's time against cuDNN's
conv + LeakyReLU (the library yardstick, timed only), the bound, the
achieved TFLOP/s and the error against the plain twin, then the totals per
step and per request: which shapes lose time. bf16 always; ``--fp32``
adds the fp32 parity kernel. ``--host`` prints the host time of one call
(K1's wrapper, its weight packing, cuDNN's conv + LeakyReLU) at a small
layer, where the host and not the kernel sets the time. ``--against DIR``
builds the fp32 kernel of another checkout (``DIR/ssdn_tpu_torch/csrc/
shifted_conv.cu``, e.g. the parent commit unpacked with ``git archive``)
beside this one, and holds this tree's fp32 K1 to its bits on every layer
shape, timing the two in turns. ``--out`` writes the rows as JSON. It
imports no JAX; ``chip_smoke.py`` runs the full checks on the real
operands.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from ssdn_tpu_torch.kernels import _build
from ssdn_tpu_torch.kernels import shifted_conv as K1

ENC, DEC = 48, 96  # the flagship's widths


def trunk_layers(n, h, w, cin=3):
    """(name, (n, cin, h, w, cout)) of the 12 K1 layers of one trunk call:
    enc0-enc6 (a 2x2 pool after enc1-enc5), then dec5b-dec1b."""
    out = [("enc0", (n, cin, h, w, ENC)), ("enc1", (n, ENC, h, w, ENC))]
    for i in range(2, 7):
        out.append((f"enc{i}", (n, ENC, h >> (i - 1), w >> (i - 1), ENC)))
    for s in (5, 4, 3, 2, 1):
        out.append((f"dec{s}b", (n, DEC, h >> (s - 1), w >> (s - 1), DEC)))
    return out


PATHS = {
    "train step": trunk_layers(4 * cs.TRAIN_BATCH, cs.PATCH, cs.PATCH),
    "request": [(f"{name} {h}x{w}", shape) for h, w in (cs.KODAK, cs.KODAK[::-1])
                for name, shape in trunk_layers(2, h, w)],
}


def operands(shape, dtype, seed):
    n, cin, h, w, cout = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, cin, h, w, device="cuda", generator=g).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=g) * (2 / (9 * cin)) ** 0.5
    b = torch.randn(cout, device="cuda", generator=g) * 0.1
    return x, wt, b


def layer_row(name, shape, dtype, reps, seed):
    x, wt, b = operands(shape, dtype, seed)
    err = cs.k1_error(torch, K1.shifted_conv3x3_bias_act(x, wt, b),
                      K1.torch_reference(x, wt, b))
    ms = cs.cuda_ms(torch, lambda: K1.shifted_conv3x3_bias_act(x, wt, b), reps)
    lib = cs.cuda_ms(torch, lambda: cs.k1_library(x, wt, b), reps)
    bound_ms, by = cs.k1_cost(torch, x, wt)
    n, cin, h, w, cout = shape
    flop = 2 * n * h * w * 9 * cin * cout
    plan = K1.k1_plan(n, h, w, cin, cout, dtype)
    return dict(layer=name, shape=shape, dtype=cs.dname(torch, dtype),
                instantiation=plan.instantiation, tile=(plan.tile_h, plan.tile_w),
                ms=ms, library_ms=lib, bound_ms=bound_ms, bound_by=by,
                tflops=flop / ms * 1e-9, max_abs_err=err[0], ok=err[2])


def host_us(fn, n=300):
    """Host time of one call of fn (no synchronisation inside the loop)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_rows(shape=(2, 48, 16, 24, 48)):
    n, cin, h, w, cout = shape
    x, wt, b = operands(shape, torch.bfloat16, 0)
    plan = K1.k1_plan(n, h, w, cin, cout, torch.bfloat16)
    print(f"host time per call at {shape}, bf16:")
    for name, fn in (
            ("K1 wrapper", lambda: K1.shifted_conv3x3_bias_act(x, wt, b)),
            ("  of it: pack_weights", lambda: K1.pack_weights(wt, plan)),
            ("cuDNN conv + LeakyReLU", lambda: cs.k1_library(x, wt, b))):
        print(f"  {name:<24} {host_us(fn):7.1f} us")


def other_fp32(tree):
    """The fp32 K1 of another checkout as a function (x, w, b) -> y: its
    ``csrc/shifted_conv.cu`` built into this tree's build directory. The
    C entry point is ``shifted_conv3x3_f32``, or (before the bf16 kernel
    had an entry point of its own) ``shifted_conv3x3_bias_act`` with
    is_bf16 0."""
    src = os.path.join(tree, "ssdn_tpu_torch", "csrc", "shifted_conv.cu")
    lib_path = os.path.join(_build.BUILD_DIR, "against_shifted_conv.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                   check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(lib_path)
    args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
    if hasattr(lib, "shifted_conv3x3_f32"):
        fn, extra = lib.shifted_conv3x3_f32, ()
    else:
        fn, extra = lib.shifted_conv3x3_bias_act, (0,)
        args.append(ctypes.c_int)
    fn.argtypes, fn.restype = args + [ctypes.c_void_p], ctypes.c_int

    def run(x, w, b):
        n, cin, h, wd = x.shape
        wk = w.permute(2, 3, 1, 0).contiguous()
        y = torch.empty((n, w.shape[0], h, wd), dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last)
        err = fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(), n, h,
                 wd, cin, w.shape[0], 0.1, *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's K1 failed: CUDA error {err}")
        return y
    return run


def against_rows(tree, reps):
    """fp32 K1 of this tree against another tree's: bits on every layer,
    times in turns (other, this, this, other)."""
    other = other_fp32(tree)
    same_all = True
    for path, layers in PATHS.items():
        t_other = t_this = 0.0
        for i, (name, shape) in enumerate(layers):
            x, wt, b = operands(shape, torch.float32, i)
            same = torch.equal(other(x, wt, b), K1.shifted_conv3x3_bias_act(x, wt, b))
            same_all &= same
            if not same:
                print(f"  fp32 bits differ from {tree} at {name} {shape}")
            fns = (lambda: other(x, wt, b),
                   lambda: K1.shifted_conv3x3_bias_act(x, wt, b))
            ms = [cs.cuda_ms(torch, fns[j], reps) for j in (0, 1, 1, 0)]
            t_other += (ms[0] + ms[3]) / 2
            t_this += (ms[1] + ms[2]) / 2
        print(f"fp32 {path}: {tree} {t_other:.3f} ms, this tree {t_this:.3f} ms "
              f"({t_this / t_other - 1:+.2%}), {len(layers)} layers")
    print(f"fp32 bits equal to {tree} on every layer: {same_all}")
    return same_all


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--fp32", action="store_true",
                   help="also time the fp32 parity kernel")
    p.add_argument("--host", action="store_true",
                   help="print the host time of one call at a small layer")
    p.add_argument("--against", default=None, metavar="DIR",
                   help="hold fp32 K1 to the bits of another checkout's")
    p.add_argument("--out", default=None, help="write the rows as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    dtypes = [torch.bfloat16] + ([torch.float32] if args.fp32 else [])
    rows, ok = [], True
    for dtype in dtypes:
        for path, layers in PATHS.items():
            tot = dict(ms=0.0, library_ms=0.0, bound_ms=0.0)
            print(f"{path}, {cs.dname(torch, dtype)}: layer, shape (n, cin, h, "
                  "w, cout), tile, K1 ms, cuDNN ms, K1/cuDNN, bound ms, TFLOP/s")
            for i, (name, shape) in enumerate(layers):
                r = layer_row(name, shape, dtype, args.reps, seed=i)
                r["path"] = path
                rows.append(r)
                ok &= r["ok"]
                for f in tot:
                    tot[f] += r[f]
                print(f"  {name:<16} {str(shape):<26} {r['instantiation']:<7} "
                      f"{str(r['tile']):<9} {r['ms']:8.3f} {r['library_ms']:8.3f} "
                      f"{r['ms'] / r['library_ms']:6.2f}x {r['bound_ms']:7.3f} "
                      f"{r['tflops']:7.1f}" + ("" if r["ok"] else "  FAIL"))
            print(f"  total: K1 {tot['ms']:.3f} ms, cuDNN {tot['library_ms']:.3f} "
                  f"ms, bound {tot['bound_ms']:.3f} ms, {len(layers)} launches")
    if args.host:
        host_rows()
    if args.against:
        ok &= against_rows(args.against, args.reps)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=cs.card_line(), rows=rows), f, indent=1)
    if not ok:
        print("k1_probe: a layer is out of the twin's tolerance, or its fp32 "
              "bits differ from the other tree's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
