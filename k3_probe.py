#!/usr/bin/env python3
"""K3 (the fused head's backward) alone on one NVIDIA GPU, bf16.

    python3 k3_probe.py

On random operands at the model's widths (C 96, Na 384, Nb 96) and a real
batch-384 step's M (1,572,864, and 1,572,851 for a ragged tail), prints
each of K3's outputs against its plain twin (error, range, where), the row
of the worst dx error with the smallest |pre2| of that row (a mask tie
when it is near zero), and K3's time per call split into its three
kernels. It imports no JAX; ``chip_smoke.py`` runs the full checks.
"""

import sys

import torch

import chip_smoke as cs
from ssdn_tpu_torch.kernels import nin_head as K2


def names(k):
    return ([f"dx{i}" for i in range(k)] + [f"dWa{i}" for i in range(k)]
            + ["dba", "dWb", "dbb", "dWc", "dbc"])


def case(m, k, nc, dt=torch.bfloat16, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs, was, rest = cs.random_head(torch, g, m, k, nc, dt)
    gout = torch.randn(m, nc, device="cuda", generator=g)
    _, h1 = K2.torch_reference_fwd(xs, was, *rest)
    args = (xs, was, h1, rest[1], rest[2], rest[3], gout)
    flat = lambda r: [*r[0], *r[1], *r[2:]]
    got = flat(K2.nin_head_bwd(*args))
    ref = flat(K2.torch_reference_bwd(*args))
    torch.cuda.synchronize()
    print(f"M={m} k={k} nc={nc} {dt}")
    for n, a, b in zip(names(k), got, ref):
        d = (a.float() - b.float()).abs()
        rng = b.float().abs().max().item()
        i = d.argmax().item()
        at = tuple(int(v) for v in torch.unravel_index(torch.tensor(i), d.shape))
        print(f"  {n:5s} err {d.max().item():.3e} range {rng:.3e} rel "
              f"{d.max().item() / max(rng, 1e-30):.3e} at {at}")
    d = (got[0].float() - ref[0].float()).abs()
    row = int(d.max(1).values.argmax())
    pre2 = h1[row].float() @ rest[1].float() + rest[2].float()
    print(f"  dx0 worst row {row}: min |pre2| {pre2.abs().min().item():.3e}")
    return args


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    case(1_572_851, 4, 9)
    args = case(1_572_864, 4, 10, seed=3)
    run = lambda: K2.nin_head_bwd(*args)
    for _ in range(2):
        print(f"K3 bf16 {cs.cuda_ms(torch, run, 5):.3f} ms per call, "
              f"{cs.k3_parts(torch, run, 5)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
