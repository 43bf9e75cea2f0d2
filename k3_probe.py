#!/usr/bin/env python3
"""K3 (the fused head's backward) alone on one NVIDIA GPU.

    python3 k3_probe.py [--reps N] [--fp32] [--against DIR]

On random operands at the model's widths (k 4, C 96, Na 384, Nb 96) and a
real batch-384 step's M (1,572,864, Nc 10; and 1,572,851, Nc 9, for a
ragged tail), prints each of K3's outputs against its plain twin (error,
range, where), the row of the worst dx error with the smallest |pre2| of
that row (a mask tie when it is near zero), and K3's time per call split
into its launches, in bf16.

``--fp32`` does the same for the fp32 FMA kernels, and builds copies of
``csrc/nin_head_bwd.cu`` for the design's variants (``F32_VARIANTS``:
textual edits of the source; "this" is the source as it stands). It prints
each fp32 kernel's registers and spills from each build log, holds every
copy against the twin (``chip_smoke.k3_error``'s fp32 bar) and against the
committed kernel's bits, and times the copies in turns (forward order, then
reverse): each launch's time, its TFLOP/s and its bound ((a1) the rows
launch, (a2) dx, (b) the weight-grad partials), beside the twin and the
library yardstick (the torch-ops head's autograd backward, TF32 off).
Every edit must match the source once (``tests/test_torch_k3_plan.py``
checks).

``--against DIR`` builds another checkout's ``csrc/nin_head_bwd.cu`` (e.g.
the parent commit's tree) and, at the same two M in both dtypes, says
whether every output's bits equal this tree's and times the two in turns
(other, this, this, other). It imports no JAX; ``chip_smoke.py`` runs the
full checks.
"""

import argparse
import ctypes
import os
import sys

import torch

import chip_smoke as cs
import k2_probe
from ssdn_tpu_torch.kernels import _build
from ssdn_tpu_torch.kernels import nin_head as K2

K = 4
CASES = (("K3 step", 1_572_864, 10), ("K3 ragged", 1_572_851, 9))
SOURCE = os.path.join(_build.CSRC, "nin_head_bwd.cu")
FMA_KERNELS = ("bwd_rows_fma_kernel", "bwd_dx_fma_kernel")

# name: textual edits (old, new) of csrc/nin_head_bwd.cu; each old occurs once
F32_VARIANTS = {
    # the FMA loops' K unrolled by 16 or 32 (the whole slice) in (a1), not
    # by 8; by 16 in (a2), not 32
    "rows_unroll16": [("ROWS_UNROLL = 8;", "ROWS_UNROLL = 16;")],
    "rows_unroll32": [("ROWS_UNROLL = 8;", "ROWS_UNROLL = 32;")],
    "dx_unroll16": [("DX_UNROLL = 32;", "DX_UNROLL = 16;")],
    # dx in chunks of 96 columns of k C (8 x 6 micro-tiles; at the model's
    # C 96 one branch per chunk) instead of 128 (8 x 8, chunks straddle
    # branches)
    "dx_chunk96": [("constexpr int DX_NCH = 128;", "constexpr int DX_NCH = 96;")],
}


def names(k):
    return ([f"dx{i}" for i in range(k)] + [f"dWa{i}" for i in range(k)]
            + ["dba", "dWb", "dbb", "dWc", "dbc"])


def flat(r):
    return [*r[0], *r[1], *r[2:]]


def operands(m, k, nc, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs, was, rest = cs.random_head(torch, g, m, k, nc, dt)
    gout = torch.randn(m, nc, device="cuda", generator=g)
    _, h1 = K2.torch_reference_fwd(xs, was, *rest)
    return xs, was, h1, rest[1], rest[2], rest[3], gout


def errors(got, ref, k, ties, h1=None, wb=None, bb=None):
    """Prints each output's error against the twin; returns ok:
    ``chip_smoke.k3_error``'s bar, bf16's dx held on the rows whose dpre2
    mask is not a tie (``chip_smoke.pre2_ties``; at most one in 1,000)."""
    for n, a, b in zip(names(k), flat(got), flat(ref)):
        d = (a.float() - b.float()).abs()
        rng = b.float().abs().max().item()
        i = d.argmax().item()
        at = tuple(int(v) for v in torch.unravel_index(torch.tensor(i), d.shape))
        print(f"    {n:5s} err {d.max().item():.3e} range {rng:.3e} rel "
              f"{d.max().item() / max(rng, 1e-30):.3e} at {at}")
    if h1 is not None:
        d = (got[0][0].float() - ref[0][0].float()).abs()
        row = int(d.max(1).values.argmax())
        pre2 = h1[row].float() @ wb.float() + bb.float()
        print(f"    dx0 worst row {row}: min |pre2| {pre2.abs().min().item():.3e}")
    bf16 = got[0][0].dtype == torch.bfloat16
    n_ties = int(ties.sum()) if bf16 else 0
    ok = cs.k3_error(torch, got, ref, bf16, keep=~ties if bf16 else None)[2]
    print(f"    {n_ties} tie rows")
    return ok and n_ties <= max(1, ties.numel() // 1000)


def use(so):
    """Make the wrapper launch the kernels of library ``so``."""
    lib = ctypes.CDLL(so)
    lib.nin_head_bwd.argtypes = K2._BWD_SIGNATURES["nin_head_bwd"]
    lib.nin_head_bwd.restype = ctypes.c_int
    _build._libs["nin_head_bwd"] = lib


def part_costs(args):
    """{part: (TFLOP, bound ms, "bytes" | "operations")} of (a1) the rows
    launch, (a2) dx and (b) the weight-grad partials (with (c)); bf16's
    rows launch is the whole of (a). Operations from the widths, bytes with
    each input read once and each output written once."""
    xs, was, h1, wb, bb, wc, g = args
    m, c = xs[0].shape
    k, na, nb, nc = len(xs), h1.shape[1], wb.shape[1], wc.shape[1]
    es = xs[0].element_size()
    dw = (k * c * na + na + na * nb + nb + nb * nc + nc) * 4
    parts = {
        "rows": (2 * m * (2 * na * nb + nb * nc),
                 m * (2 * na + 2 * nb) * es + m * nc * 4),
        "dx": (2 * m * k * c * na, m * na * es + 2 * k * m * c * es),
        "wgrad": (2 * m * (k * c * na + na * nb + nb * nc),
                  m * (k * c + 2 * na + 2 * nb) * es + m * nc * 4 + dw),
    }
    if xs[0].dtype == torch.bfloat16:  # one rows launch: (a1) and (a2)
        dx = parts.pop("dx")
        parts["rows"] = (parts["rows"][0] + dx[0],
                         parts["rows"][1] + dx[1] - m * na * es)
    return {p: (ops / 1e12, *cs.bound(nbytes, ops, cs.dname(torch, xs[0].dtype)))
            for p, (ops, nbytes) in parts.items()}


def timed_in_turns(libs, args, reps):
    """{name: [(total ms, {part: ms}) forward order, ... reverse order]}."""
    run = lambda: K2.nin_head_bwd(*args)
    times = {v: [] for v in libs}
    for order in (list(libs), list(libs)[::-1]):
        for v in order:
            use(libs[v])
            times[v].append((cs.cuda_ms(torch, run, reps),
                             cs.k3_parts(torch, run, reps)))
    return times


def run_case(name, m, nc, libs, reps, dt, seed):
    """Each library's errors against the twin and bits against the first
    library's, then the libraries timed in turns, each launch beside its
    bound, and (fp32) the twin and the library yardstick."""
    args = operands(m, K, nc, dt, seed)
    print(f"{name}: M={m} k={K} nc={nc} {cs.dname(torch, dt)}")
    ref = K2.torch_reference_bwd(*args)
    ties = cs.pre2_ties(torch, *args[2:5])
    first, ok_all = None, True
    for v in libs:
        use(libs[v])
        got = K2.nin_head_bwd(*args)
        torch.cuda.synchronize()
        print(f"  {v}:")
        ok = errors(got, ref, K, ties, *(args[2:5] if first is None else ()))
        if first is None:
            first = (v, got)
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(first[1])))
        ok_all &= ok
        print(f"    same bits as {first[0]}: {same}; {'ok' if ok else 'FAIL'}")
        del got
    del ref, first, ties
    costs = part_costs(args)
    total = sum(t for t, _, _ in costs.values())
    for v, ts in timed_in_turns(libs, args, reps).items():
        print(f"  {v:<12} " + " / ".join(f"{t:.3f}" for t, _ in ts)
              + f" ms ({total / min(t for t, _ in ts) * 1e3:.1f} TFLOP/s)")
        for part, (tflop, b_ms, by) in costs.items():
            ms = [p[part] for _, p in ts]
            if not min(ms):  # the parent's fp32 dx ran inside its rows kernel
                print(f"    ({part}) not launched")
                continue
            print(f"    ({part}) " + " / ".join(f"{t:.3f}" for t in ms)
                  + f" ms, {tflop / min(ms) * 1e3:.1f} TFLOP/s, bound "
                  f"{b_ms:.3f} ms ({by})")
        print(f"    (reduce) " + " / ".join(f"{p['reduce']:.3f}" for _, p in ts)
              + " ms")
    if dt == torch.float32:
        twin = cs.cuda_ms(torch, lambda: K2.torch_reference_bwd(*args), reps)
        lib = cs.cuda_ms(torch, cs.k3_library(torch, args), reps)
        print(f"  twin {twin:.3f} ms, library {lib:.3f} ms")
    return ok_all


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--reps", type=int, default=5,
                   help="launches per timing (default 5)")
    p.add_argument("--fp32", action="store_true",
                   help="also hold and time the fp32 kernels and their variants")
    p.add_argument("--against", default=None, metavar="DIR",
                   help="bits and times against another checkout's kernels")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("k3_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    copies = {"this": [], **(F32_VARIANTS if a.fp32 else {})}
    libs, logs = k2_probe.build_copies(copies, a.against, SOURCE)
    for name in copies:
        for kern in FMA_KERNELS:
            print(f"  {name}: {kern} "
                  f"{k2_probe.fma_registers(logs[name], kern)}")
    ok = True
    try:
        with torch.no_grad():
            for i, (name, m, nc) in enumerate(CASES):
                ok &= run_case(name, m, nc, {"this": libs["this"]}, a.reps,
                               torch.bfloat16, seed=1 + i)
            if a.fp32:
                f32 = {n: libs[n] for n in copies}
                for i, (name, m, nc) in enumerate(CASES):
                    ok &= run_case(name, m, nc, f32, a.reps, torch.float32,
                                   seed=11 + i)
            if a.against:
                print(f"against {a.against} (other), in turns: other, this, "
                      f"this, other")
                pair = {"other": libs["other"], "this": libs["this"]}
                for dt in (torch.bfloat16, torch.float32):
                    for i, (name, m, nc) in enumerate(CASES):
                        ok &= run_case(name, m, nc, pair, a.reps, dt,
                                       seed=21 + i)
    finally:
        _build._libs.pop("nin_head_bwd", None)  # the next launch loads the real kernels
    print(f"k3_probe: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
