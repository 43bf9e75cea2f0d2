"""What ``ops/`` and ``kernels/`` share, kept here so that ``ops`` imports
``kernels`` and never the reverse: the precision contract of fp32 convs and
matmuls (``precision_scope``), a tensor's memory format (``layout_of``),
LeakyReLU, and the torch ops that follow a conv (``epilogue_ops``: the bias
add, the blind-spot row mask, the cast, LeakyReLU) at their rounding
points. ``ops.shifted.conv2d`` runs ``epilogue_ops`` where the hand-written
epilogue does not run, and ``kernels.conv_epilogue``'s twin is built on it.
"""

from __future__ import annotations

import contextlib

import torch


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU(0.1) used after every conv except the final 1x1 [P][N2N]."""
    return torch.where(x >= 0, x, negative_slope * x)


@contextlib.contextmanager
def precision_scope(dtype: torch.dtype, precision: str | None):
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


def layout_of(t: torch.Tensor) -> torch.memory_format:
    """channels_last where t is NHWC-dense, else contiguous_format."""
    if t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def epilogue_ops(y: torch.Tensor, b: torch.Tensor | None, down_shift: int = 0,
                 negative_slope: float | None = None,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The torch ops after a conv's output y (N, C, H, W): the bias added in
    y's dtype, rows [0, down_shift) zeroed (the blind-spot shift's masked
    rows), the cast to ``out_dtype``, then ``leaky_relu`` where a slope is
    given."""
    if b is not None:
        y = y + b.to(y.dtype).view(1, -1, 1, 1)
    if down_shift:
        row = torch.arange(y.shape[2], device=y.device)
        y = y * (row >= down_shift).to(y.dtype).view(1, 1, -1, 1)
    if out_dtype is not None:
        y = y.to(out_dtype)
    if negative_slope is not None:
        y = leaky_relu(y, negative_slope)
    return y
