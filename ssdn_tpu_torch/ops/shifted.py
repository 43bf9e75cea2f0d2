"""Shifted ("causal-upward") spatial ops — the blind-spot building blocks,
in PyTorch (port of ``ssdn_tpu/ops/shifted.py``).

Every op here preserves the invariant

    output at row r depends only on input rows <= r.

Layout: tensors are NCHW (PyTorch's logical order), kept in
``torch.channels_last`` memory format by the model so that the hand-written
kernels see NHWC-contiguous memory; conv weights are OIHW. The shift is a
zero pad of the top rows before a VALID convolution (negative pads crop).

Precision contract (as ``_resolve_precision`` in the JAX package): fp32
inputs compute in true fp32 — cuDNN's default TF32 convolutions keep only
~3 decimal digits, so the fp32 convs switch TF32 off around their forward
AND their backward (``_conv_valid``: the gradient convs run later, outside
the forward's context, as JAX's transpose rules carry the op's precision).
bf16 inputs take the fast path: cuDNN accumulates in fp32 and rounds the
output to bf16, the same contract as the TPU's MXU path.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU(0.1) used after every conv except the final 1x1 [P][N2N]."""
    return torch.where(x >= 0, x, negative_slope * x)


def shift_down(x: torch.Tensor, rows: int = 1) -> torch.Tensor:
    """Move content down `rows` pixels: out[:, :, r] = x[:, :, r - rows]
    (zero fill) — the final +1 px shift that turns "rows <= r" into
    "rows < r", creating the blind spot (SURVEY.md §2.4)."""
    if rows == 0:
        return x
    return F.pad(x, (0, 0, rows, -rows))


@contextlib.contextmanager
def _precision(dtype: torch.dtype, precision: str | None):
    """fp32 inputs at precision "highest" (the default) run with TF32 off
    for both cuDNN convs and cuBLAS matmuls; "high"/"default" allow TF32.
    Precision tiers only apply to fp32 (the flags do not touch bf16)."""
    if dtype != torch.float32:
        yield
        return
    allow = (precision or "highest") != "highest"
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


class _ConvAtPrecision(torch.autograd.Function):
    """VALID conv2d of fp32 operands whose backward (the input- and
    weight-gradient convs) runs under the same ``_precision`` as its
    forward. Plain autograd would run them later, outside the forward's
    context, at whatever TF32 setting the process has (cuDNN's default is
    TF32 on)."""

    @staticmethod
    def forward(ctx, x, w, precision):
        ctx.save_for_backward(x, w)
        ctx.precision = precision
        with _precision(x.dtype, precision):
            return F.conv2d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # the op plain autograd calls for F.conv2d, with the same arguments
        # (so the same algorithms and bits), inside the forward's precision
        with _precision(x.dtype, ctx.precision):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, (1, 1), (0, 0), (1, 1), False, (0, 0), 1,
                (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return dx, dw, None


def _conv_valid(x: torch.Tensor, w: torch.Tensor,
                precision: str | None) -> torch.Tensor:
    """VALID conv2d at the precision contract: fp32 through
    ``_ConvAtPrecision`` (forward and backward at ``precision``); other
    dtypes, which the TF32 flags do not touch, on plain autograd."""
    if x.dtype == torch.float32:
        return _ConvAtPrecision.apply(x, w, precision)
    return F.conv2d(x, w)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    shifted: bool = False,
    down_shift: int = 0,
    out_dtype: torch.dtype | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """2-D conv, NCHW x OIHW -> NCHW, SAME width padding, fp32 accumulation.

    shifted=True pads the top by (Kh - 1) and the bottom by 0, so output
    row r reads input rows r-(Kh-1) .. r. down_shift=k (shifted only) folds
    shift_down(out, k) into the same pad as (Kh-1+k, -k); the top k rows,
    which would otherwise hold the bias, are zeroed by a row mask after the
    bias add, as shift_down zero-fills them.

    The bias is added after the conv in the output dtype (not inside
    cuDNN's epilogue), matching the JAX op's rounding points in bf16.
    """
    kh, kw = w.shape[2], w.shape[3]
    if shifted:
        hpad = (kh - 1 + down_shift, -down_shift)
    else:
        if down_shift:
            raise ValueError("down_shift requires shifted=True")
        hpad = ((kh - 1) // 2, kh // 2)
    wpad = ((kw - 1) // 2, kw // 2)
    xp = F.pad(x, (wpad[0], wpad[1], hpad[0], hpad[1]))
    out = _conv_valid(xp, w.to(x.dtype), precision)
    if b is not None:
        out = out + b.to(out.dtype).view(1, -1, 1, 1)
    if down_shift:
        row = torch.arange(out.shape[2], device=out.device)
        out = out * (row >= down_shift).to(out.dtype).view(1, 1, -1, 1)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out


def maxpool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool (VALID). Unshifted form is the baseline U-Net path
    (N2C/N2N)."""
    return F.max_pool2d(x, 2)


def shifted_maxpool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool with the one-row downward offset: pooled row R covers
    input rows (2R-1, 2R), so every upsampled row r still only sees rows
    <= r (SURVEY.md §2.4). The pad row is -inf so it never wins the max."""
    return maxpool_2x2(F.pad(x, (0, 0, 1, -1), value=float("-inf")))


def upsample_2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor 2x upsample: output row r reads row floor(r/2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _MatmulAccF32(torch.autograd.Function):
    """The JAX package's ``matmul_acc_f32`` custom VJP (``_mm_bwd``): the
    cotangent is cast to x's dtype before both products; dx is formed in
    x's dtype, dw accumulates in fp32.

    The JAX op sets no precision of its own, and this one adds no option.
    Its products are true fp32 products for fp32 operands (what the port's
    fp32 contract and the CPU give): cuBLAS reads
    ``torch.backends.cuda.matmul.allow_tf32``, so they run with that flag
    False (``_precision(x.dtype, "highest")``) rather than relying on the
    process to keep PyTorch's default. bf16 operands, upcast exactly, fit
    TF32's mantissa; for them the flag is left as the process has it."""

    @staticmethod
    def forward(ctx, x, w):
        w_lp = w.to(x.dtype)
        ctx.save_for_backward(x, w_lp)
        ctx.w_dtype = w.dtype
        with _precision(x.dtype, "highest"):
            return torch.matmul(x.float(), w_lp.float())

    @staticmethod
    def backward(ctx, g):
        x, w_lp = ctx.saved_tensors
        gl = g.to(x.dtype)
        dx = dw = None
        with _precision(x.dtype, "highest"):
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(gl, w_lp.t())
            if ctx.needs_input_grad[1]:
                k = x.shape[-1]
                dw = torch.matmul(x.reshape(-1, k).t().float(),
                                  gl.reshape(-1, g.shape[-1]).float())
                dw = dw.to(ctx.w_dtype)
        return dx, dw


def matmul_acc_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) -> fp32 with fp32 accumulation, for low-precision
    (e.g. bf16) operands; w is cast to x's dtype first. Upcasting is exact:
    a product of two bf16 values is representable in fp32, so this is the
    bf16-operand / fp32-accumulate product.

    The backward is the JAX package's custom VJP: the cotangent is cast to
    x's dtype, dx = g_lp @ w^T in x's dtype, dw accumulates in fp32 and
    comes back in w's own dtype. Pass w in fp32 (the parameter) to keep dw
    in fp32, as JAX does; torch would round an fp32 gradient of a bf16 w."""
    return _MatmulAccF32.apply(x, w)


def _collapse_upsample_kernel(w_up: torch.Tensor) -> torch.Tensor:
    """Collapse a 3x3 OIHW kernel meant for nearest-2x-upsampled input into
    the equivalent coarse-resolution 2x3 kernel, (4*Cout, Cin, 2, 3), with
    output channels ordered (co, pr, pc) for ``pixel_shuffle``.

    Derivation (shifted geometry: out[R, C] = sum_{i,j} u[R-2+i, C-1+j]
    W[i,j] with u[Y, X] = h[Y//2, X//2]); writing R = 2r+pr, C = 2c+pc,
    each fine output phase (pr, pc) reads a 2x2 window of h whose weights
    are sums of the original taps:

        rows  (offset r-1+a):  pr=0: a=0 <- W[0]+W[1], a=1 <- W[2]
                               pr=1: a=0 <- W[0],      a=1 <- W[1]+W[2]
        cols  (offset c-1+b):  pc=0: b=0 <- W[:,0], b=1 <- W[:,1]+W[:,2], b=2 <- 0
                               pc=1: b=0 <- 0, b=1 <- W[:,0]+W[:,1], b=2 <- W[:,2]

    The JAX package stacks the phases (pr, pc, co) for its own layout; the
    taps are the same.
    """
    w = w_up
    r0 = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2)
    r1 = torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2)
    rows = torch.stack([r0, r1])                   # (pr, Co, Ci, a, 3)
    z = torch.zeros_like(rows[..., 0])
    c0 = torch.stack([rows[..., 0], rows[..., 1] + rows[..., 2], z], dim=-1)
    c1 = torch.stack([z, rows[..., 0] + rows[..., 1], rows[..., 2]], dim=-1)
    wc = torch.stack([c0, c1])                     # (pc, pr, Co, Ci, a, b)
    wc = wc.permute(2, 1, 0, 3, 4, 5)              # (Co, pr, pc, Ci, a, b)
    co, ci = w.shape[0], w.shape[1]
    return wc.reshape(4 * co, ci, 2, 3)


def shifted_upsample_concat_conv(
    h: torch.Tensor,
    skip: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    out_dtype: torch.dtype | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """conv2d(cat([upsample_2x_nearest(h), skip], 1), w, b, shifted=True)
    computed exactly, without materializing the upsample or the concat.

    h: (N, Cup, Hc, Wc) coarse features; skip: (N, Cskip, 2Hc, 2Wc);
    w: (Cout, Cup + Cskip, 3, 3) — the SAME parameters as the unfused path.

    The upsampled part runs as one coarse-resolution 2x3 conv with 4*Cout
    output channels (``_collapse_upsample_kernel``; zero pad top 1, bottom
    0, sides 1 — exact, since fine row/col -1 and 2Wc map to coarse -1 and
    Wc) followed by ``pixel_shuffle``. The JAX package reaches the same sum
    through an lhs-dilated conv with a remapped (4, 6) kernel, a form XLA's
    TPU lowering prefers; cuDNN has no lhs dilation, and the phase conv
    plus depth-to-space is its direct equivalent. The skip part is a
    standard shifted conv; both add into the same output.
    """
    cup = h.shape[1]
    w_up = w[:, :cup]
    w_skip = w[:, cup:]
    up = _conv_valid(F.pad(h, (1, 1, 1, 0)),
                     _collapse_upsample_kernel(w_up).to(h.dtype), precision)
    up = F.pixel_shuffle(up, 2)
    skip_part = conv2d(skip.to(h.dtype), w_skip, None, shifted=True,
                       precision=precision)
    out = up + skip_part
    if b is not None:
        out = out + b.to(out.dtype).view(1, -1, 1, 1)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out
