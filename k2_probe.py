#!/usr/bin/env python3
"""K2/K2' (the fused head's forward) alone on one NVIDIA GPU, bf16.

    python3 k2_probe.py [--reps N] [--ablations]

On random operands at the model's widths (k 4, C 96, Na 384, Nb 96, Nc 10)
and at a batch-384 training step's M (1,572,864, and 1,572,851 for a
ragged tail: K2', which saves h1) and a 768x512 request's M (393,216: K2),
it builds copies of ``csrc/nin_head.cu`` for the design's variants
(``VARIANTS``: textual edits of the source, "fixed" is the source as it
stands), prints each one's errors against the plain twin and whether its
bits equal the committed kernel's, and times the variants in turns in this
one process (forward order, then reverse), beside the twin, the library
yardstick (three ``addmm``) and the bound.

``--ablations`` also builds copies with one part of the kernel's work taken
out (``ABLATIONS``; their results are wrong: they are timed only) and
times them in turns with the whole kernel: where the time goes, with no
profiler of the kernel's insides on the machine. Every edit must match the
source once (``tests/test_torch_k2_plan.py`` checks). It imports no JAX;
``chip_smoke.py`` runs the full checks.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from ssdn_tpu_torch.kernels import _build
from ssdn_tpu_torch.kernels import nin_head as K2

K, NC = 4, 10
CASES = (("K2' step", 1_572_864, True), ("K2' ragged", 1_572_851, True),
         ("K2 request", 393_216, False))
SOURCE = os.path.join(_build.CSRC, "nin_head.cu")

_MODEL = "  const bool model = a.k == 4 && a.C == 96 && a.Na == 384 && a.Nb == 96;\n"
_H1_WHOLE = "      __syncwarp();  // this warp's h1 chunk is whole\n"
# name: textual edits (old, new) of csrc/nin_head.cu; each old occurs once
VARIANTS = {
    "fixed": [],  # the committed kernel: widths fixed at compile time
    "generic": [(_MODEL, "  const bool model = false;\n")],  # run-time widths
    "two_syncs": [(_H1_WHOLE, _H1_WHOLE + "      __syncthreads();\n")],
    "two_blocks": [  # two 4-warp blocks per SM, 16-column chunks to fit
        ("constexpr int TC_WARPS = 8;", "constexpr int TC_WARPS = 4;"),
        ("constexpr int NCH = 32;", "constexpr int NCH = 16;"),
        ("constexpr int TC_MINB = 1;", "constexpr int TC_MINB = 2;")],
}
_RING = ("      if (s + STAGES - 1 < steps)\n"
         "        load_stage(s + STAGES - 1, (s + STAGES - 1) % STAGES);")
_NO_RING = (_RING, _RING.replace("< steps)", "< steps && s + STAGES - 1 < STAGES)"))
_NO_SYNC = ("      __syncthreads();     // ... for every thread; stage (s - 1) is free\n", "")
ABLATIONS = {
    "no_weight_ring": [_NO_RING],  # each block loads the weights' first chunks only
    "no_mma": [("#include \"tc_bf16.cuh\"\n",
                "#include \"tc_bf16.cuh\"\n#define mma_bf16(...) ((void)0)\n")],
    "no_x_reload": [("        if (it + 1 < my_tiles) load_x(tile + gridDim.x);\n", "")],
    "no_ring_no_barrier": [_NO_RING, _NO_SYNC],
}


def edited_source(edits):
    """csrc/nin_head.cu with each (old, new) applied; old must occur once."""
    with open(SOURCE) as f:
        s = f.read()
    for old, new in edits:
        if s.count(old) != 1:
            raise RuntimeError(f"csrc/nin_head.cu holds {old!r} "
                               f"{s.count(old)} times, not once")
        s = s.replace(old, new)
    return s


def build_copies(copies):
    """{name: library} for edited copies of the source ({name: edits}), one
    nvcc each, all at once."""
    out = os.path.join(_build.BUILD_DIR, "k2_probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, edits in copies.items():
        path = os.path.join(out, f"nin_head_{name}.cu")
        with open(path, "w") as f:
            f.write(edited_source(edits))
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT), path[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{log.decode()}")
        libs[name] = so
    return libs


def use(so):
    """Make the wrapper launch the kernel of library ``so``."""
    lib = ctypes.CDLL(so)
    lib.nin_head_fwd.argtypes = K2._SIGNATURES["nin_head_fwd"]
    lib.nin_head_fwd.restype = ctypes.c_int
    _build._libs["nin_head"] = lib


def timed_in_turns(libs, run, reps):
    """{name: [ms forward order, ms reverse order]}."""
    times = {v: [] for v in libs}
    for order in (list(libs), list(libs)[::-1]):
        for v in order:
            use(libs[v])
            times[v].append(cs.cuda_ms(torch, run, reps))
    return times


def flops(m):
    return 2 * m * (K * 96 * 384 + 384 * 96 + 96 * NC)


def run_case(name, m, save_h1, libs, reps, g):
    xs, was, rest = cs.random_head(torch, g, m, K, NC, torch.bfloat16)
    args = (xs, was, *rest)
    ref, ref_h1 = K2.torch_reference_fwd(*args)
    outs = {}
    print(f"{name}: M={m} save_h1={save_h1}")
    for v in libs:
        use(libs[v])
        out, h1 = K2.nin_head_fwd(*args, save_h1=save_h1)
        e = cs.k2_error(out, ref, True)
        msg = f"  {v:<10} out err {e[0]:.3e} rel {e[1]:.3e}"
        ok = e[2]
        if save_h1:
            eh = cs.k1_error(torch, h1, ref_h1)
            msg += f", h1 err {eh[0]:.3e} rel {eh[1]:.3e}"
            ok = ok and eh[2]
        outs[v] = out
        print(msg + f", same bits as fixed {torch.equal(out, outs['fixed'])}"
              f" {'ok' if ok else 'FAIL'}")
    del ref, ref_h1, outs
    run = lambda: K2.nin_head_fwd(*args, save_h1=save_h1)
    times = timed_in_turns(libs, run, reps)
    bound, by = cs.k2_cost(torch, xs, was, rest[1], rest[3], save_h1=save_h1)
    twin = cs.cuda_ms(torch, lambda: K2.torch_reference_fwd(*args), reps)
    lib = cs.cuda_ms(torch, lambda: cs.head_library(*args), reps)
    for v, ts in times.items():
        best = min(ts)
        print(f"  {v:<10} " + " / ".join(f"{t:.3f}" for t in ts)
              + f" ms ({flops(m) / best / 1e9:.1f} TFLOP/s)")
    print(f"  bound {bound:.3f} ms ({by}), twin {twin:.3f} ms, "
          f"library {lib:.3f} ms")


def time_ablations(libs, reps, g):
    print("ablations of the committed kernel (results wrong, timed only):")
    for name, m, save_h1 in (CASES[2], CASES[0]):
        xs, was, rest = cs.random_head(torch, g, m, K, NC, torch.bfloat16)
        args = (xs, was, *rest)
        times = timed_in_turns(
            libs, lambda: K2.nin_head_fwd(*args, save_h1=save_h1), reps)
        print(f"  {name}: M={m} " + ", ".join(
            f"{a} " + " / ".join(f"{v:.3f}" for v in ts) + " ms"
            for a, ts in times.items()))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--reps", type=int, default=10,
                   help="launches per timing (default 10)")
    p.add_argument("--ablations", action="store_true",
                   help="also time the kernel with parts taken out")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("k2_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    g = torch.Generator(device="cuda").manual_seed(5)
    copies = dict(VARIANTS, **(ABLATIONS if a.ablations else {}))
    libs = build_copies(copies)
    variants = {v: libs[v] for v in VARIANTS}
    try:
        with torch.no_grad():
            for name, m, save_h1 in CASES:
                run_case(name, m, save_h1, variants, a.reps, g)
            if a.ablations:
                time_ablations({"whole": libs["fixed"],
                                **{n: libs[n] for n in ABLATIONS}}, a.reps, g)
    finally:
        _build._libs.pop("nin_head", None)  # the next launch loads the real kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
