"""K1: fused causal-up 3x3 conv + bias + LeakyReLU (port of the TPU kernel
``ssdn_tpu/ops/pallas/shifted_conv.py :: shifted_conv3x3_bias_act``).

``shifted_conv3x3_bias_act`` launches the hand-written CUDA kernel
(``csrc/shifted_conv.cu``) on CUDA tensors, or raises; on CPU tensors, and
only there, it computes the plain PyTorch twin ``torch_reference``. There
is no size-based fallback: the TPU kernel sent large images to XLA because
VMEM is small; the CUDA kernel takes every shape the model produces.

``fused_shifted_conv`` is the differentiable entry point (the JAX
package's ``fused_shifted_conv`` custom VJP): an ``autograd.Function``
whose forward is the wrapper above (K1 on CUDA, the twin on the CPU) and
whose backward, ``shifted_conv_bwd``, is the JAX ``_fused_bwd`` in torch
ops (cuDNN on the card), as the JAX package's is XLA. The same backward
runs on both devices, so the CPU tests check the math the card runs.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ssdn_tpu_torch.kernels import refuse_graph_cut
from ssdn_tpu_torch.ops.shifted import _precision

#: Number of CUDA launches of K1 since the last reset (set it to 0 to reset).
launches = 0

_SIGNATURES = {
    "shifted_conv3x3_bias_act": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_DTYPES = (torch.float32, torch.bfloat16)


def torch_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    negative_slope: float = 0.1) -> torch.Tensor:
    """Plain PyTorch twin with the kernel's rounding points: the conv of
    x and w (cast to x's dtype) accumulated in fp32 — exact products, since
    a bf16 product fits in fp32 — bias and LeakyReLU in fp32, one rounding
    to x's dtype. x: (N, Cin, H, W); w: (Cout, Cin, 3, 3); b: (Cout,).
    Returns NCHW in channels_last memory format."""
    xp = F.pad(x.float(), (1, 1, 2, 0))  # causal up: 2 rows on top, 0 below
    acc = F.conv2d(xp, w.to(x.dtype).float()) + b.float().view(1, -1, 1, 1)
    out = torch.where(acc >= 0, acc, negative_slope * acc)
    return out.to(x.dtype).contiguous(
        memory_format=torch.channels_last)


def _check(x, w, b):
    if x.dtype not in _DTYPES:
        raise TypeError(f"K1 takes float32 or bfloat16 input, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({w.shape[0]},)")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("K1 needs x in channels_last (NHWC-contiguous) memory")
    for t in (w, b):
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if x.numel() == 0:
        raise ValueError("K1 got an empty input")


def shifted_conv3x3_bias_act(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, *, negative_slope: float = 0.1
                             ) -> torch.Tensor:
    """lrelu(conv3x3_causal_up(x, w) + b), NCHW in channels_last memory.

    x: (N, Cin, H, W) float32 or bfloat16; w: (Cout, Cin, 3, 3), cast to
    x's dtype; b: (Cout,), applied in fp32. The output dtype is x's (the
    kernel writes its input type).
    """
    if x.device.type == "cpu":
        return torch_reference(x, w, b, negative_slope=negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {x.device}")
    _check(x, w, b)
    refuse_graph_cut("K1 shifted_conv3x3_bias_act", x, w, b)
    from ssdn_tpu_torch.kernels import _build

    lib = _build.load("shifted_conv", _SIGNATURES)
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    # (Cout, Cin, 3, 3) -> (3, 3, Cin, Cout) = the kernel's (9*Cin, Cout)
    wk = w.to(x.dtype).permute(2, 3, 1, 0).contiguous()
    bias = b.to(torch.float32).contiguous()
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        err = lib.shifted_conv3x3_bias_act(
            x.data_ptr(), wk.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n, h, wd, cin, cout, negative_slope,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"K1 shifted_conv3x3_bias_act launch failed: "
                           f"CUDA error {err}")
    global launches
    launches += 1
    return y


def _conv_acc_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID conv2d of x with w (cast to x's dtype), accumulated in fp32 and
    rounded once to x's dtype. On the card cuDNN does exactly that for bf16
    operands; on the CPU the operands are upcast first (exact), so both
    devices round at the same point."""
    w = w.to(x.dtype)
    if x.device.type == "cuda":
        return F.conv2d(x, w)
    return F.conv2d(x.float(), w.float()).to(x.dtype)


def shifted_conv_bwd(x, w, out, g, negative_slope: float = 0.1):
    """(dx, dw, db) of ``lrelu(conv3x3_causal_up(x, w) + b)``: the JAX
    package's ``_fused_bwd`` in torch ops.

    The LeakyReLU mask comes from the output's sign bit (``signbit``, not
    ``out >= 0``: a negative pre-activation that rounds to -0.0 in bf16
    takes the slope side, as in the forward). dpre is rounded to x's dtype;
    dx is the conv of dpre with the flipped, IO-transposed weights, padded
    (0, 2) in rows and (1, 1) in columns, fp32 accumulation, in x's dtype;
    dw is the per-tap contraction of the padded input with dpre in fp32,
    cast to w's dtype; db the fp32 sum of dpre."""
    g = g.float()
    dpre = torch.where(torch.signbit(out), negative_slope * g, g).to(x.dtype)
    w_rot = w.flip(2, 3).transpose(0, 1)  # (Cin, Cout, 3, 3)
    with _precision(x.dtype, "highest"):
        dx = _conv_acc_f32(F.pad(dpre, (1, 1, 0, 2)), w_rot)
    with _precision(torch.float32, "highest"):  # true fp32, TF32 off
        # the nine tap contractions are one weight-gradient conv
        dw = torch.nn.grad.conv2d_weight(
            F.pad(x, (1, 1, 2, 0)).float(), w.shape, dpre.float())
    db = dpre.float().sum(dim=(0, 2, 3))
    return dx, dw.to(w.dtype), db


class _FusedShiftedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, negative_slope):
        out = shifted_conv3x3_bias_act(x, w, b, negative_slope=negative_slope)
        ctx.save_for_backward(x, w, out)
        ctx.slope = negative_slope
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        return (*shifted_conv_bwd(x, w, out, g, ctx.slope), None)


def fused_shifted_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                       negative_slope: float = 0.1) -> torch.Tensor:
    """Differentiable ``shifted_conv3x3_bias_act`` (same arguments and
    output). Where autograd records (grad mode on, an input requires grad)
    it runs the ``autograd.Function``; otherwise the plain wrapper."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _FusedShiftedConv.apply(x, w, b, negative_slope)
    return shifted_conv3x3_bias_act(x, w, b, negative_slope=negative_slope)
