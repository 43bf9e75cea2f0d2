"""K1: fused causal-up 3x3 conv + bias + LeakyReLU (port of the TPU kernel
``ssdn_tpu/ops/pallas/shifted_conv.py :: shifted_conv3x3_bias_act``).

``shifted_conv3x3_bias_act`` launches the hand-written CUDA kernel
(``csrc/shifted_conv.cu``) on CUDA tensors, or raises; on CPU tensors, and
only there, it computes the plain PyTorch twin ``torch_reference``. There
is no size-based fallback: the TPU kernel sent large images to XLA because
VMEM is small; the CUDA kernel takes every shape the model produces.

The forward only: the custom backward (an ``autograd.Function`` over torch
convs, as the JAX package's is XLA) comes with the training step.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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
