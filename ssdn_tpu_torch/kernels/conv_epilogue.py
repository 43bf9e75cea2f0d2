"""The epilogue of a bf16 trunk conv: bias + LeakyReLU, the crop of a conv
run with cuDNN's own padding, and dec1b's blind-spot shift, in one pass
forward (``epilogue_fwd``) and one backward (``epilogue_bwd``),
``csrc/conv_epilogue.cu``. It replaces no TPU kernel: XLA fuses these ops
into the conv on the TPU, and eager PyTorch ran each as a pass of its own.

Each wrapper launches the kernel on CUDA tensors, or raises; on CPU tensors,
and only there, it computes its plain twin (``torch_reference``,
``torch_reference_bwd``): the folded conv's crop and shift, then the torch
ops ``ops.shifted.conv2d`` runs where the kernel does not
(``numerics.epilogue_ops``). Given the same conv output both give the same
bits (the backward's zeros may differ in sign).

The differentiable entry points, called by ``ops.shifted`` for bf16
channels_last CUDA tensors (``takes``) and by the CPU tests on any device:

- ``conv_bias_act``: a conv with symmetric padding whose output rows [0, H)
  (shifted: the crop of the Kh - 1 rows the bottom padding adds) go through
  the epilogue. Its backward writes the conv's output gradient with the
  cropped rows zeroed and runs ``aten.convolution_backward`` with the same
  padding, so dx comes out in x's shape: no padded copy is made or saved.
- ``bias_act``: the epilogue alone, for the fused decoder's up + skip sum.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ssdn_tpu_torch.kernels import refuse_graph_cut
from ssdn_tpu_torch.numerics import epilogue_ops

#: CUDA launches since the last reset (set to 0 to reset): the forward
#: epilogue, the backward epilogue.
launches = 0
launches_bwd = 0

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                      ctypes.c_void_p]
_SIGNATURES = {"conv_epilogue_fwd": _ARGS, "conv_epilogue_bwd": _ARGS}


def takes(x: torch.Tensor, channels: int) -> bool:
    """Whether the kernel runs for a conv (or sum) on x whose epilogue has
    ``channels`` channels: x bf16 channels_last on CUDA (the bf16 trunk's
    activations) and channels a multiple of 8 (the kernel's 16-byte
    vectors). Elsewhere the callers keep the torch ops."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and channels % 8 == 0
            and x.is_contiguous(memory_format=torch.channels_last))


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """t channels_last where ref is (the kernel takes that layout), else t.
    A channels_last view that starts off a 16-byte boundary, which the
    kernel refuses, is copied (the trunk's gradients are fresh tensors)."""
    if ref.is_contiguous(memory_format=torch.channels_last):
        t = t.contiguous(memory_format=torch.channels_last)
        if t.data_ptr() % 16:
            t = t.clone(memory_format=torch.channels_last)
    return t


def torch_reference(c: torch.Tensor, b: torch.Tensor, rows: int,
                    shift: int = 0,
                    negative_slope: float | None = None) -> torch.Tensor:
    """The forward kernel's twin: out (N, C, rows, W) from the conv output
    c (N, C, Hc, W). Rows [0, rows - shift) of c, shifted down by ``shift``
    with zero rows above, are the conv ``ops.shifted.conv2d`` pads for; its
    torch ops (``epilogue_ops``: bias, row mask, LeakyReLU) follow."""
    y = c[:, :, :rows - shift]
    if shift:
        y = F.pad(y, (0, 0, shift, 0))
    return _like(epilogue_ops(y, b, shift, negative_slope), c)


def torch_reference_bwd(g: torch.Tensor, out: torch.Tensor | None, hc: int,
                        shift: int = 0,
                        negative_slope: float | None = None) -> torch.Tensor:
    """The backward kernel's twin: the gradient of the conv output, (N, C,
    hc, W), from out's gradient g (N, C, H, W): LeakyReLU's (read from out:
    g where out >= 0, else g * slope rounded), moved up ``shift`` rows, and
    zero in the rows no output reads."""
    d = g if negative_slope is None else torch.where(out >= 0, g,
                                                     negative_slope * g)
    d = d[:, :, shift:]
    return _like(F.pad(d, (0, 0, 0, hc - d.shape[2])), g)


def _lib():
    from ssdn_tpu_torch.kernels import _build

    return _build.load("conv_epilogue", _SIGNATURES)


def _check(t: torch.Tensor, name: str, c: int, dev) -> None:
    if t.dtype != torch.bfloat16 or t.device != dev:
        raise ValueError(f"conv epilogue: {name} must be bf16 on {dev}, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() != 4 or t.shape[1] != c:
        raise ValueError(f"conv epilogue: {name} must be (N, {c}, H, W), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv epilogue: {name} must be channels_last")


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"conv epilogue runs on cuda or cpu tensors, not "
                         f"{x.device}")
    return True


def _raise_for(err: int, kernel: str, shape, c: int) -> None:
    """cudaErrorInvalidValue (1), returned before any launch: the launcher
    refuses the sizes or alignment (C % 8, 16-byte pointers)."""
    if err == 1:
        raise ValueError(f"{kernel}: launcher refuses {shape} (C {c}: "
                         "C % 8 == 0 and 16-byte aligned operands)")
    if err:
        raise RuntimeError(f"{kernel} launch failed at {shape}: CUDA error "
                           f"{err}")


def epilogue_fwd(c: torch.Tensor, b: torch.Tensor, rows: int, shift: int = 0,
                 negative_slope: float | None = None) -> torch.Tensor:
    """out (N, C, rows, W) bf16 channels_last from the conv output c (N, C,
    Hc, W) bf16 channels_last and the bias b (C,): the kernel on CUDA,
    ``torch_reference`` on the CPU."""
    if not _on_cuda(c):
        return torch_reference(c, b, rows, shift, negative_slope)
    n, ch, hc, w = c.shape
    _check(c, "c", ch, c.device)
    if tuple(b.shape) != (ch,) or not 0 <= shift <= rows or hc < rows - shift:
        raise ValueError(f"conv epilogue: c {tuple(c.shape)}, b "
                         f"{tuple(b.shape)}, rows {rows}, shift {shift}")
    refuse_graph_cut("conv_epilogue_fwd", c, b)
    bias = b.to(device=c.device, dtype=torch.float32).contiguous()
    out = torch.empty((n, ch, rows, w), dtype=c.dtype, device=c.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(c.device):
        err = _lib().conv_epilogue_fwd(
            c.data_ptr(), bias.data_ptr(), out.data_ptr(), n, hc, rows, w,
            ch, shift, int(negative_slope is not None),
            0.0 if negative_slope is None else negative_slope,
            torch.cuda.current_stream().cuda_stream)
    _raise_for(err, "conv_epilogue_fwd", tuple(c.shape), ch)
    global launches
    launches += 1
    return out


def epilogue_bwd(g: torch.Tensor, out: torch.Tensor | None, hc: int,
                 shift: int = 0,
                 negative_slope: float | None = None) -> torch.Tensor:
    """The conv output's gradient (N, C, hc, W) bf16 channels_last from
    out's gradient g and out (N, C, H, W), both bf16 channels_last (out is
    read only with an activation): the kernel on CUDA,
    ``torch_reference_bwd`` on the CPU."""
    if not _on_cuda(g):
        return torch_reference_bwd(g, out, hc, shift, negative_slope)
    n, ch, h, w = g.shape
    _check(g, "g", ch, g.device)
    act = negative_slope is not None
    if act:
        _check(out, "out", ch, g.device)
        if out.shape != g.shape:
            raise ValueError(f"conv epilogue: out {tuple(out.shape)} and g "
                             f"{tuple(g.shape)} differ")
    if not 0 <= shift <= h or hc < h - shift or hc < 1:
        raise ValueError(f"conv epilogue: g {tuple(g.shape)}, hc {hc}, "
                         f"shift {shift}")
    refuse_graph_cut("conv_epilogue_bwd", g, *([out] if act else []))
    dpre = torch.empty((n, ch, hc, w), dtype=g.dtype, device=g.device,
                       memory_format=torch.channels_last)
    with torch.cuda.device(g.device):
        err = _lib().conv_epilogue_bwd(
            g.data_ptr(), out.data_ptr() if act else None, dpre.data_ptr(),
            n, hc, h, w, ch, shift, int(act), negative_slope if act else 0.0,
            torch.cuda.current_stream().cuda_stream)
    _raise_for(err, "conv_epilogue_bwd", tuple(g.shape), ch)
    global launches_bwd
    launches_bwd += 1
    return dpre


class _ConvBiasAct(torch.autograd.Function):
    """conv2d(x, w, padding) -> rows [0, rows) through the epilogue. Saves
    x, the conv weight in x's dtype and, with an activation, out."""

    @staticmethod
    def forward(ctx, x, w, b, padding, rows, shift, negative_slope):
        w_lp = w.to(x.dtype)
        c = _like(F.conv2d(x, w_lp, None, 1, padding), x)
        out = epilogue_fwd(c, b, rows, shift, negative_slope)
        ctx.save_for_backward(x, w_lp,
                              out if negative_slope is not None else None)
        ctx.conf = (padding, c.shape[2], shift, negative_slope, w.dtype,
                    b.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_lp, out = ctx.saved_tensors
        padding, hc, shift, slope, w_dtype, b_dtype = ctx.conf
        dpre = epilogue_bwd(_like(g, x), out, hc, shift, slope)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x or need_w:
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dpre, x, w_lp, None, (1, 1), padding, (1, 1), False, (0, 0),
                1, (need_x, need_w, False))
            if dw is not None:
                dw = dw.to(w_dtype)
        if need_b:
            db = dpre.sum((0, 2, 3)).to(b_dtype)
        return dx, dw, db, None, None, None, None


class _BiasAct(torch.autograd.Function):
    """The epilogue alone (no crop, no shift). Saves out."""

    @staticmethod
    def forward(ctx, s, b, negative_slope):
        out = epilogue_fwd(s, b, s.shape[2], 0, negative_slope)
        ctx.save_for_backward(out)
        ctx.conf = (negative_slope, b.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        slope, b_dtype = ctx.conf
        dpre = epilogue_bwd(_like(g, out), out, out.shape[2], 0, slope)
        db = dpre.sum((0, 2, 3)).to(b_dtype) if ctx.needs_input_grad[1] else None
        return dpre, db, None


def conv_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  padding: tuple[int, int], shift: int = 0,
                  negative_slope: float | None = None) -> torch.Tensor:
    """Differentiable ``epilogue(conv2d(x, w, padding=padding))`` keeping
    x's rows: out (N, Cout, H, W) from x (N, Cin, H, W). The conv weight is
    cast to x's dtype (its gradient comes back in w's); shift moves the
    output down that many rows as ``ops.shifted.conv2d``'s down_shift."""
    return _ConvBiasAct.apply(x, w, b, tuple(padding), x.shape[2], shift,
                              negative_slope)


def bias_act(s: torch.Tensor, b: torch.Tensor,
             negative_slope: float | None) -> torch.Tensor:
    """Differentiable ``leaky_relu(s + b)`` at the torch ops' rounding
    points (the bias add rounded to s's dtype, then the activation)."""
    return _BiasAct.apply(s, b, negative_slope)
