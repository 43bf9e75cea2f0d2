#!/usr/bin/env python3
"""K1 (the shifted 3x3 conv + bias + LeakyReLU) alone on one NVIDIA GPU,
layer by layer.

    python3 k1_probe.py [--reps N] [--fp32] [--variants] [--host]
                        [--against DIR] [--window DIR] [--out PATH]
    python3 k1_probe.py --held GB [GB ...] [--out PATH]

On random operands (made on the card from a seed) at the 12 layer shapes
of a batch-384 training step (the four rotations folded into batch 1536,
64x64 patches) and the 24 of a 768x512 request (two trunk calls of batch
2, at 512x768 and 768x512), prints per layer K1's time against cuDNN's
conv + LeakyReLU (the library yardstick, timed only), the bound, the
achieved TFLOP/s and the error against the plain twin, then the totals per
step and per request: which shapes lose time. bf16 always; ``--fp32``
adds the fp32 parity kernel and prints its registers and spills (ptxas).
``--variants`` times the fp32 kernel's design choices (``F32_VARIANTS``:
edited copies of ``csrc/shifted_conv.cu`` and plan overrides) against
this build over a training step's 12 layers, in turns, each held to this
build's bit patterns.
``--host`` prints the host time of one call
(K1's wrapper, its weight packing, cuDNN's conv + LeakyReLU) at a small
layer, where the host and not the kernel sets the time. ``--against DIR``
builds the fp32 kernel of another checkout (``DIR/ssdn_tpu_torch/csrc/
shifted_conv.cu``, e.g. the parent commit unpacked with ``git archive``)
beside this one, and holds this tree's fp32 K1 to its bit patterns on
every layer shape (-0.0 is not +0.0: the backward's mask is the output's
sign bit), timing the two in turns. ``--window DIR`` times the reference
objective's fp32 training step in the conv arm (``chip_smoke.
train_reference_fp32``, fp32 K1 12 times a step) on DIR's package and on
this tree's, one process each, in turns (DIR, this, this, DIR).
``--held GB ...`` runs alone: the bf16 conv arm's training step (K1
forward, its torch-ops autograd backward; the blind zoo model on
``chip_smoke``'s batch-384 batch) in a fresh process per turn that first
takes GB of device memory with a dummy tensor, the values in turns
forward then backward (0 40 60 60 40 0). cuDNN's heuristic mode keeps,
per process, the first algorithm whose workspace it could allocate, so
the memory free at a process's first step can fix the algorithms of K1's
backward convs for its life. Each turn prints ms per step (host clock
over 10 steps after 3 warm-ups, a synchronize as the barrier), the device
busy ms and top kernels of one profiled step, and the step's own peak
device memory (the held tensor not counted). ``--out`` writes the rows
as JSON. It imports no JAX; ``chip_smoke.py`` runs the
full checks on the real operands.
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
import k2_probe
from ssdn_tpu_torch.kernels import _build
from ssdn_tpu_torch.kernels import shifted_conv as K1

ENC, DEC = 48, 96  # the flagship's widths
SOURCE = os.path.join(_build.CSRC, "shifted_conv.cu")

# fp32 K1's design choices: (edits of csrc/shifted_conv.cu, overrides of
# kernels/shifted_conv.py's plan constants). The same bits in every one.
_UNROLL = "#pragma unroll 2\n      for (; k < stop; k += 4) {"
F32_VARIANTS = {
    # one block per SM: no 128-register cap
    "one_block": ([("constexpr int F_MINB = 2;", "constexpr int F_MINB = 1;")],
                  {}),
    # a 2-stage weight ring (one stage's loads in flight, not two)
    "stages2": ([("constexpr int F_STAGES = 3;", "constexpr int F_STAGES = 2;")],
                {"_F32_STAGES": 2}),
    # 16 or 64 weight rows per ring stage (a barrier per 4 or 16 k' steps)
    "kr16": ([], {"_F32_KR": 16}),
    "kr64": ([], {"_F32_KR": 64}),
    # the k' loop unrolled by 1 or 4 (2 shipped)
    "unroll1": ([(_UNROLL, _UNROLL.replace("unroll 2", "unroll 1"))], {}),
    "unroll4": ([(_UNROLL, _UNROLL.replace("unroll 2", "unroll 4"))], {}),
    # tiles 32 or 8 columns wide (16 shipped): 4 x 32 (6 x 34 halo slots)
    # or 16 x 8 (18 x 10) at 128 pixels
    "tile32": ([("constexpr int F_MAX_TW = 16;", "constexpr int F_MAX_TW = 32;")],
               {"_F32_MAX_TW": 32}),
    "tile8": ([], {"_F32_MAX_TW": 8}),
}


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
    C entry point is ``shifted_conv3x3_f32_halo`` (given this tree's plan
    and packed weights), or before that ``shifted_conv3x3_f32`` (the
    (9*Cin, Cout) matrix), or (before the bf16 kernel had an entry point
    of its own) ``shifted_conv3x3_bias_act`` with is_bf16 0."""
    src = os.path.join(tree, "ssdn_tpu_torch", "csrc", "shifted_conv.cu")
    lib_path = os.path.join(_build.BUILD_DIR, "against_shifted_conv.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                   check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(lib_path)
    halo = hasattr(lib, "shifted_conv3x3_f32_halo")
    if halo:
        fn, extra = lib.shifted_conv3x3_f32_halo, ()
        fn.argtypes = K1._SIGNATURES["shifted_conv3x3_f32_halo"]
    else:
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
        if hasattr(lib, "shifted_conv3x3_f32"):
            fn, extra = lib.shifted_conv3x3_f32, ()
        else:
            fn, extra = lib.shifted_conv3x3_bias_act, (0,)
            args.append(ctypes.c_int)
        fn.argtypes = args + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, w, b):
        n, cin, h, wd = x.shape
        cout = w.shape[0]
        y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last)
        stream = torch.cuda.current_stream().cuda_stream
        if halo:
            plan = K1.k1_plan(n, h, wd, cin, cout, x.dtype)
            wk = K1.pack_weights_f32(w, plan)
            err = fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(),
                     n, h, wd, cin, cout, plan.cols, plan.tile_w, plan.tile_h,
                     plan.cc, plan.kr, 0.1, stream)
        else:
            wk = w.permute(2, 3, 1, 0).contiguous()
            err = fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(),
                     n, h, wd, cin, cout, 0.1, *extra, stream)
        if err:
            raise RuntimeError(f"the other tree's K1 failed: CUDA error {err}")
        return y
    return run


def fma_registers(log):
    """ptxas's registers and spills of each fp32 FMA kernel instantiation
    in a build log (``-Xptxas=-v``): [(kernel, "Used .. registers ..",
    ".. spill stores, .. spill loads")]."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties" in line and "conv_fma_kernel" in line:
            name = line.split("for ")[-1].strip()
            cols = name.split("conv_fma_kernelILi")[-1].split("E")[0]
            out.append((f"conv_fma_kernel<{cols}>",
                        lines[i + 2].split(": ")[-1].strip(),
                        lines[i + 1].strip()))
    return out


def against_rows(tree, reps):
    """fp32 K1 of this tree against another tree's: bits on every layer,
    times in turns (other, this, this, other)."""
    other = other_fp32(tree)
    same_all = True
    for path, layers in PATHS.items():
        t_other = t_this = 0.0
        for i, (name, shape) in enumerate(layers):
            x, wt, b = operands(shape, torch.float32, i)
            same = cs.same_bits(torch, other(x, wt, b),
                                K1.shifted_conv3x3_bias_act(x, wt, b))
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


def use(so, overrides):
    """Make the wrapper launch K1 from library ``so`` with the plan's
    constants overridden; returns the constants it replaced."""
    lib = ctypes.CDLL(so)
    for fn, argtypes in K1._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _build._libs["shifted_conv"] = lib
    old = {k: getattr(K1, k) for k in overrides}
    for k, v in overrides.items():
        setattr(K1, k, v)
    return old


def variant_rows(reps):
    """fp32 K1's design variants against this build over the 12 layers of
    a training step: their registers and spills, bit patterns equal to
    this build's on every layer, and the step's K1 time in turns (this and
    the variants in order, then in reverse)."""
    copies = {"this": [], **{n: e for n, (e, _) in F32_VARIANTS.items()}}
    overrides = {"this": {}, **{n: o for n, (_, o) in F32_VARIANTS.items()}}
    libs, logs = k2_probe.build_copies(copies, None, SOURCE)
    for name in copies:
        for kern, regs, spills in fma_registers(logs[name]):
            print(f"  {name}: {kern} {regs}; {spills}")
    layers = [operands(shape, torch.float32, i)
              for i, (_, shape) in enumerate(PATHS["train step"])]
    run = lambda: [K1.shifted_conv3x3_bias_act(*ops) for ops in layers]
    times, same, ref = {v: [] for v in copies}, {}, None
    try:
        for order in (list(copies), list(copies)[::-1]):
            for v in order:
                old = use(libs[v], overrides[v])
                try:
                    outs = run()
                    if ref is None:
                        ref = outs
                    same[v] = same.get(v, True) and all(
                        cs.same_bits(torch, a, b) for a, b in zip(outs, ref))
                    del outs
                    times[v].append(cs.cuda_ms(torch, run, reps))
                finally:
                    for k, val in old.items():
                        setattr(K1, k, val)
    finally:
        _build._libs.pop("shifted_conv", None)  # the next launch loads the real kernel
    print("fp32 K1 variants, ms per training step (12 layers), in turns:")
    for v in copies:
        print(f"  {v:<10} {times[v][0]:8.3f} / {times[v][1]:8.3f}"
              f"{'' if same[v] else '  BITS DIFFER'}")
    return [dict(variant=v, ms=times[v], same_bits=same[v]) for v in copies]


# one reference-window process: the tree's package first on the path, this
# tree's chip_smoke loaded from its file; prints the row as JSON
_WINDOW = """
import importlib.util, json, sys
sys.path.insert(0, {tree!r})
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import ssdn_tpu_torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cs.REF_ARMS = ("conv_pallas",)
models = {{"gauss25_rgb": cs.load_model("gauss25_rgb", "cuda")}}
report = {{}}
row = cs.train_reference_fp32(torch, models, report)[0]
print("WINDOW " + json.dumps(dict(row, package=ssdn_tpu_torch.__file__,
      launches=report["reference_train_launches"]["conv_pallas"])))
"""


def window_rows(tree):
    """The conv arm's reference window on ``tree``'s package and this
    tree's, one process each, in turns (other, this, this, other)."""
    here = os.path.dirname(os.path.abspath(__file__))
    smoke = os.path.join(here, "chip_smoke.py")
    torch.cuda.empty_cache()  # the child processes need the card's memory
    rows = []
    for tag, root in (("other", tree), ("this", here), ("this", here),
                      ("other", tree)):
        run = subprocess.run(
            [sys.executable, "-c", _WINDOW.format(tree=os.path.abspath(root),
                                                  smoke=smoke)],
            capture_output=True, text=True, cwd=here)
        line = next((ln for ln in run.stdout.splitlines()
                     if ln.startswith("WINDOW ")), None)
        if run.returncode or line is None:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {tag} tree's reference window failed")
        row = dict(json.loads(line[len("WINDOW "):]), tree=tag)
        rows.append(row)
        print(f"  conv arm, fp32 reference step, {tag} ({row['package']}): "
              f"{row['ms_per_step']:.2f} ms/step {row['patches_per_s']:.1f} "
              f"patches/s, launches {row['launches']}")
    return rows


# one --held turn: a fresh process takes `held` GB, then steps the conv arm
_HELD = """
import json, torch
import chip_smoke as cs
from ssdn_tpu_torch.train import make_train_step, state_from_params
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
held = {held!r}
dummy = (torch.empty(int(held * 1e9), dtype=torch.uint8, device="cuda")
         if held else None)
cfg, params = cs.load_model("gauss5_50_blind_rgb", "cuda")
cfg = cs.train_cfg(cs.blind_fixed_sigma(cfg), "conv_pallas")
batch = cs.train_batch_u8()
ts = make_train_step(cfg, device="cuda")
torch.cuda.reset_peak_memory_stats()
state, _, dt = cs.timed_steps(torch, ts, state_from_params(params), batch,
                              3, 10)
busy, top = cs.device_profile(torch, lambda: ts(state, batch))
print("HELD " + json.dumps(dict(
    held_gb=held, ms_per_step=dt / 10 * 1e3, device_busy_ms=busy,
    own_peak_gb=torch.cuda.max_memory_allocated() / 1e9 - held,
    top=[(k[:50], ms) for k, ms, _ in top[:6]])))
"""


def held_rows(held):
    """The conv arm's step in a fresh process per turn, ``held`` GB taken
    before its first step, in turns forward then backward."""
    here = os.path.dirname(os.path.abspath(__file__))
    rows = []
    for gb in held + held[::-1]:
        run = subprocess.run([sys.executable, "-c", _HELD.format(held=gb)],
                             capture_output=True, text=True, cwd=here)
        line = next((ln for ln in run.stdout.splitlines()
                     if ln.startswith("HELD ")), None)
        if run.returncode or line is None:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the turn with {gb} GB held failed")
        rows.append(json.loads(line[len("HELD "):]))
        r = rows[-1]
        print(f"  conv arm, bf16 step, {gb} GB held: {r['ms_per_step']:.1f} "
              f"ms/step, device busy {r['device_busy_ms']:.1f} ms, own peak "
              f"{r['own_peak_gb']:.1f} GB; top: "
              + ", ".join(f"{k} {ms:.1f}" for k, ms in r["top"]))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--fp32", action="store_true",
                   help="also time the fp32 parity kernel")
    p.add_argument("--variants", action="store_true",
                   help="time the fp32 kernel's design variants in turns")
    p.add_argument("--host", action="store_true",
                   help="print the host time of one call at a small layer")
    p.add_argument("--against", default=None, metavar="DIR",
                   help="hold fp32 K1 to the bits of another checkout's")
    p.add_argument("--window", default=None, metavar="DIR",
                   help="time the conv arm's fp32 reference step on DIR's "
                        "package and this one's, in turns")
    p.add_argument("--held", type=float, nargs="+", default=None,
                   metavar="GB", help="only: the conv arm's step in a fresh "
                   "process per turn with GB of device memory held first")
    p.add_argument("--out", default=None, help="write the rows as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.held:
        print(cs.card_line())
        rows = held_rows(args.held)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(card=cs.card_line(), held=rows), f, indent=1)
        return 0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    if args.fp32:
        for kern, regs, spills in fma_registers(_build.build_log("shifted_conv")):
            print(f"  {kern}: {regs}; {spills}")
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
    variants = []
    if args.variants:
        with torch.no_grad():
            variants = variant_rows(args.reps)
        ok &= all(v["same_bits"] for v in variants)
    windows = window_rows(args.window) if args.window else []
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=cs.card_line(), rows=rows, variants=variants,
                           windows=windows), f, indent=1)
    if not ok:
        print("k1_probe: a layer is out of the twin's tolerance, or its fp32 "
              "bits differ from the other tree's or a variant's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
