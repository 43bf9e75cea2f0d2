#!/usr/bin/env python3
"""K2/K2' (the fused head's forward) alone on one NVIDIA GPU.

    python3 k2_probe.py [--reps N] [--ablations] [--fp32] [--against DIR]

On random operands at the model's widths (k 4, C 96, Na 384, Nb 96, Nc 10)
and at a batch-384 training step's M (1,572,864, and 1,572,851 for a
ragged tail: K2', which saves h1) and a 768x512 request's M (393,216: K2),
it builds copies of ``csrc/nin_head.cu`` for the bf16 design's variants
(``VARIANTS``: textual edits of the source, "fixed" is the source as it
stands), prints each one's errors against the plain twin and whether its
bits equal the committed kernel's, and times the variants in turns in this
one process (forward order, then reverse), beside the twin, the library
yardstick (``chip_smoke.head_library``: three ``addmm``) and the bound.

``--ablations`` also builds copies with one part of the bf16 kernel's work
taken out (``ABLATIONS``; their results are wrong: they are timed only) and
times them in turns with the whole kernel: where the time goes, with no
profiler of the kernel's insides on the machine. Every edit must match the
source once (the CPU test ``test_probe_edits_match_the_source`` checks).

``--fp32`` does the same for the fp32 FMA kernel (``F32_VARIANTS``; with
``--ablations`` also ``F32_ABLATIONS``): each copy's registers and spills
from its build log, errors against the twin (out 1e-5, h1 1e-5 relative),
time, TFLOP/s, the library (TF32 off) and the bound at the same three M.

``--against DIR`` builds another checkout's ``csrc/nin_head.cu`` (e.g. the
parent commit's tree) and, at the same three M in both dtypes, says whether
its out and h1 bits equal this tree's and times the two in turns (other,
this, this, other). It imports no JAX; ``chip_smoke.py`` runs the full
checks.
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
_F32_KLOOP = "#pragma unroll 16\n          for (int kk = 0; kk < F_KS; ++kk) {\n"
_F32_LANES = ("  const int ty = (warp >> 1) * 4 + (lane >> 3), "
              "tx = (warp & 1) * 8 + (lane & 7);\n")
_F32_SYNC = ("          __syncthreads();  // stage s is free; stage s + 1 "
             "(and Wb) landed\n")
_F32_LAYER_B = "#pragma unroll 4\n        for (int kk = 0; kk < F_NCH; ++kk) {\n"
# layer a's four shared reads per K step (x rows 4ty.., 64 + 4ty..; Wa_i
# columns 4tx.., 64 + 4tx..)
_F32_READS = ["(xa + kk * F_LDT)", "(xa + kk * F_LDT + 64)",
              "(wa + kk * F_NCH)", "(wa + kk * F_NCH + 64)"]
# the fp32 (FMA) kernel's design variants and ablations, edits as above
F32_VARIANTS = {
    # layer a's K loop unrolled by 8 or by the slice's 32, not by 16
    "unroll8": [(_F32_KLOOP, _F32_KLOOP.replace("unroll 16", "unroll 8"))],
    "unroll32": [(_F32_KLOOP, _F32_KLOOP.replace("unroll 16", "unroll"))],
    # a warp covers 8 x 4 (ty, tx) thread tiles, not 4 x 8
    "lanes8x4": [(_F32_LANES, "  const int ty = (warp >> 2) * 8 + (lane >> 2), "
                              "tx = (warp & 3) * 4 + (lane & 3);\n")],
}
F32_ABLATIONS = {
    "no_slice_barrier": [(_F32_SYNC, "")],
    # each block computes on its first slices: no x or Wa_i loads after them
    "no_staging": [("          const bool more = s + 1 < steps;\n",
                    "          const bool more = false;\n")],
    "no_layer_b": [(_F32_LAYER_B, _F32_LAYER_B.replace("kk < F_NCH", "kk < 0"))],
    # layer a reads its operands on even K steps only (odd steps reuse
    # them): half the shared-memory reads, the same FMAs
    "half_smem_reads": [(r, r.replace("kk *", "(kk & ~1) *")) for r in _F32_READS],
}


def edited_source(edits, source=SOURCE):
    """The source (csrc/nin_head.cu) with each (old, new) applied; old must
    occur once."""
    with open(source) as f:
        s = f.read()
    for old, new in edits:
        if s.count(old) != 1:
            raise RuntimeError(f"{os.path.basename(source)} holds {old!r} "
                               f"{s.count(old)} times, not once")
        s = s.replace(old, new)
    return s


def build_copies(copies, against=None, source=SOURCE):
    """({name: library}, {name: build log}) for edited copies of the source
    (csrc/nin_head.cu; {name: edits}) and, as "other", ``against``'s copy
    of the same file; one nvcc each, all at once."""
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    jobs = {}  # name: (source, include directory)
    for name, edits in copies.items():
        path = os.path.join(out, f"{stem}_{name}.cu")
        with open(path, "w") as f:
            f.write(edited_source(edits, source))
        jobs[name] = (path, _build.CSRC)
    if against:
        csrc = os.path.join(against, "ssdn_tpu_torch", "csrc")
        jobs["other"] = (os.path.join(csrc, os.path.basename(source)), csrc)
    procs = {}
    for name, (path, inc) in jobs.items():
        so = os.path.join(out, f"{stem}_{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs, logs = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log.decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{logs[name]}")
        libs[name] = so
    return libs, logs


def fma_registers(log, kernel="head_fwd_fma_kernel"):
    """ptxas's registers and spill line for an fp32 kernel in a build log
    (``-Xptxas=-v``)."""
    lines = log.splitlines()
    at = next(i for i, line in enumerate(lines)
              if "Function properties" in line and kernel in line)
    return f"{lines[at + 2].split(': ')[-1]}; {lines[at + 1].strip()}"


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


def fwd_errors(out, h1, ref, ref_h1):
    """(message, ok): chip_smoke's bars. bf16: out 2**-6 of the range, h1
    2 bf16 ulps; fp32: out within 1e-5, h1 within 1e-5 + 1e-5 of its value
    (the card tests' bars: summation order only)."""
    bf16 = ref_h1.dtype == torch.bfloat16
    e = cs.k2_error(out, ref, True) if bf16 else cs.fp32_error(out, ref, 0)
    msg, ok = f"out err {e[0]:.3e} rel {e[1]:.3e}", e[2]
    if h1 is not None:
        eh = cs.k1_error(torch, h1, ref_h1) if bf16 else cs.fp32_error(h1, ref_h1)
        msg += f", h1 err {eh[0]:.3e} rel {eh[1]:.3e}"
        ok = ok and eh[2]
    return msg, ok


def run_case(name, m, save_h1, libs, reps, g, dt=torch.bfloat16):
    """Each library's errors against the twin and bits against the first
    library's, then the libraries timed in turns beside the twin, the
    library yardstick and the bound."""
    xs, was, rest = cs.random_head(torch, g, m, K, NC, dt)
    args = (xs, was, *rest)
    ref, ref_h1 = K2.torch_reference_fwd(*args)
    first = None
    print(f"{name}: M={m} save_h1={save_h1} {cs.dname(torch, dt)}")
    ok_all = True
    for v in libs:
        use(libs[v])
        out, h1 = K2.nin_head_fwd(*args, save_h1=save_h1)
        msg, ok = fwd_errors(out, h1, ref, ref_h1)
        if first is None:
            first = (v, out, h1)
        same = torch.equal(out, first[1]) and (
            h1 is None or torch.equal(h1, first[2]))
        ok_all &= ok
        print(f"  {v:<10} {msg}, same bits as {first[0]} {same}"
              f" {'ok' if ok else 'FAIL'}")
        del out, h1
    del ref, ref_h1, first
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
          f"library {lib:.3f} ms ({flops(m) / lib / 1e9:.1f} TFLOP/s)")
    return ok_all


def time_ablations(libs, reps, g, dt=torch.bfloat16):
    print(f"ablations of the committed {cs.dname(torch, dt)} kernel (results "
          f"wrong, timed only):")
    for name, m, save_h1 in (CASES[2], CASES[0]):
        xs, was, rest = cs.random_head(torch, g, m, K, NC, dt)
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
                   help="also time the bf16 kernel with parts taken out")
    p.add_argument("--fp32", action="store_true",
                   help="also hold and time the fp32 FMA kernel")
    p.add_argument("--against", default=None, metavar="DIR",
                   help="bits and times against another checkout's kernel")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("k2_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    g = torch.Generator(device="cuda").manual_seed(5)
    copies = dict(VARIANTS, **(ABLATIONS if a.ablations else {}))
    if a.fp32:
        copies.update({f"f32_{n}": e for n, e in F32_VARIANTS.items()})
        if a.ablations:
            copies.update({f"f32_{n}": e for n, e in F32_ABLATIONS.items()})
    libs, logs = build_copies(copies, a.against)
    variants = {v: libs[v] for v in VARIANTS}
    if a.fp32:
        for name in ["fixed", *(n for n in copies if n.startswith("f32_"))]:
            print(f"  {name}: fp32 kernel {fma_registers(logs[name])}")
    ok = True
    try:
        with torch.no_grad():
            for name, m, save_h1 in CASES:
                ok &= run_case(name, m, save_h1, variants, a.reps, g)
            if a.ablations:
                time_ablations({"whole": libs["fixed"],
                                **{n: libs[n] for n in ABLATIONS}}, a.reps, g)
            if a.fp32:
                f32 = {"fixed": libs["fixed"],
                       **{n: libs[f"f32_{n}"] for n in F32_VARIANTS}}
                for name, m, save_h1 in CASES:
                    ok &= run_case(name, m, save_h1, f32, a.reps, g,
                                   torch.float32)
                if a.ablations:
                    time_ablations({"whole": libs["fixed"],
                                    **{n: libs[f"f32_{n}"]
                                       for n in F32_ABLATIONS}},
                                   a.reps, g, torch.float32)
            if a.against:
                print(f"against {a.against} (other), in turns: other, this, "
                      f"this, other")
                pair = {"other": libs["other"], "this": libs["fixed"]}
                for dt in (torch.bfloat16, torch.float32):
                    for name, m, save_h1 in CASES:
                        ok &= run_case(name, m, save_h1, pair, a.reps, g, dt)
    finally:
        _build._libs.pop("nin_head", None)  # the next launch loads the real kernel
    print(f"k2_probe: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
