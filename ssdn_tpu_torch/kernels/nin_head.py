"""K2: the fused 1x1 combiner head, forward / inference (port of the TPU
kernel ``ssdn_tpu/ops/pallas/nin_head.py :: _fwd_call`` as reached by
``fused_nin_head``, ``save_h1=False``):

    h1  = lrelu(sum_i lrelu(x_i) @ Wa_i + ba)   rounded to x's dtype
    h2  = lrelu(h1 @ Wb + bb)                   rounded to x's dtype
    out = h2 @ Wc + bc                          fp32

The x_i are dec1b PRE-activations (the trunk runs with ``emit_preact``);
the branch concat is never built. ``fused_nin_head`` launches the CUDA
kernel (``csrc/nin_head.cu``) on CUDA tensors, or raises; on CPU tensors,
and only there, it computes the plain twin ``torch_reference``. Any M runs:
the TPU's ``_pick_tile`` divisibility rule has no counterpart (the kernel
masks a ragged tail). The training variant (saved h1) and the backward
kernel (K3) come with the training step.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

SLOPE = 0.1
MAX_BRANCHES = 4
MAX_NA = 512  # the kernel's layer-a columns: 2 per thread x 256 threads

#: Number of CUDA launches of K2 since the last reset (set it to 0 to reset).
launches = 0

_SIGNATURES = {
    "nin_head_fwd": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_DTYPES = (torch.float32, torch.bfloat16)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    # the compare runs in fp32, as the TPU kernel's (-0.0 compares >= 0 and
    # keeps its value; both branches give -0.0 there)
    return torch.where(x.float() >= 0, x, SLOPE * x)


def torch_reference(xs: Sequence[torch.Tensor], was: Sequence[torch.Tensor],
                    ba, wb, bb, wc, bc) -> torch.Tensor:
    """Plain PyTorch twin with the kernel's rounding points: products
    accumulate in fp32 (upcasting bf16 operands first is exact), biases
    and LeakyReLU in fp32, h1 and h2 rounded once to x's dtype. In fp32 it
    is the JAX package's ``lax_reference``; in bf16 that oracle rounds
    each matmul before its bias add, the kernels round after it."""
    dt = xs[0].dtype
    acc = sum(_lrelu(x).float() @ wa.float() for x, wa in zip(xs, was))
    h1 = _lrelu(acc + ba.float()).to(dt)
    h2 = _lrelu(h1.float() @ wb.float() + bb.float()).to(dt)
    return h2.float() @ wc.float() + bc.float()


def _check(xs, was, ba, wb, bb, wc, bc):
    k = len(xs)
    if not 1 <= k <= MAX_BRANCHES or len(was) != k:
        raise ValueError(f"K2 takes 1..{MAX_BRANCHES} branches, got {k}/{len(was)}")
    dt, dev = xs[0].dtype, xs[0].device
    if dt not in _DTYPES:
        raise TypeError(f"K2 takes float32 or bfloat16 input, got {dt}")
    m, c = xs[0].shape
    na, nb, nc = was[0].shape[1], wb.shape[1], wc.shape[1]
    if na > MAX_NA:
        raise ValueError(f"K2 supports at most {MAX_NA} layer-a columns, got {na}")
    shapes = [(x, (m, c), dt) for x in xs] + [(w, (c, na), dt) for w in was] + [
        (ba, (na,), torch.float32), (wb, (na, nb), dt),
        (bb, (nb,), torch.float32), (wc, (nb, nc), dt),
        (bc, (nc,), torch.float32),
    ]
    for t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"K2 operand {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K2 operands must be contiguous, on one device")
    if m == 0:
        raise ValueError("K2 got an empty input")


def fused_nin_head(xs: Sequence[torch.Tensor], was: Sequence[torch.Tensor],
                   ba, wb, bb, wc, bc) -> torch.Tensor:
    """lrelu(lrelu(cat(xs)) @ cat(was) + ba) -> lrelu(@ wb + bb) -> @ wc + bc,
    (M, Nc) fp32.

    xs: 1..4 (M, C) tensors (fp32/bf16, pre-activations); was: matching
    (C, Na) row blocks of Wa in x's dtype; wb (Na, Nb) and wc (Nb, Nc) in
    x's dtype; ba/bb/bc fp32.
    """
    x0 = xs[0]
    if x0.device.type == "cpu":
        return torch_reference(xs, was, ba, wb, bb, wc, bc)
    if x0.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {x0.device}")
    _check(xs, was, ba, wb, bb, wc, bc)
    from ssdn_tpu_torch.kernels import _build

    lib = _build.load("nin_head", _SIGNATURES)
    k = len(xs)
    m, c = x0.shape
    na, nb, nc = was[0].shape[1], wb.shape[1], wc.shape[1]
    out = torch.empty((m, nc), dtype=torch.float32, device=x0.device)
    pad = [None] * (MAX_BRANCHES - k)
    with torch.cuda.device(x0.device):
        err = lib.nin_head_fwd(
            *[x.data_ptr() for x in xs], *pad,
            *[w.data_ptr() for w in was], *pad,
            ba.data_ptr(), wb.data_ptr(), bb.data_ptr(), wc.data_ptr(),
            bc.data_ptr(), out.data_ptr(),
            k, m, c, na, nb, nc, SLOPE, int(x0.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"K2 nin_head_fwd launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
