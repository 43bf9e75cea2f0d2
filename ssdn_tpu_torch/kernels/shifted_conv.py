"""K1: fused causal-up 3x3 conv + bias + LeakyReLU (port of the TPU kernel
``ssdn_tpu/ops/pallas/shifted_conv.py :: shifted_conv3x3_bias_act``).

``shifted_conv3x3_bias_act`` launches the hand-written CUDA kernel
(``csrc/shifted_conv.cu``: fp32 on the FMA pipes, bf16 on the tensor cores)
on CUDA tensors, or raises; on CPU tensors, and only there, it computes the
plain PyTorch twin ``torch_reference``. There is no size-based fallback:
the TPU kernel sent large images to XLA because VMEM is small; the CUDA
kernel takes every shape the model produces. ``k1_plan`` is the launch
plan (instantiation, tile, passes over Cin, shared bytes) that the wrapper
checks and passes to the kernel of either dtype.

``fused_shifted_conv`` is the differentiable entry point (the JAX
package's ``fused_shifted_conv`` custom VJP): an ``autograd.Function``
whose forward is the wrapper above (K1 on CUDA, the twin on the CPU) and
whose backward, ``shifted_conv_bwd``, is the JAX ``_fused_bwd`` in torch
ops (cuDNN on the card), as the JAX package's is XLA. The same backward
runs on both devices, so the CPU tests check the math the card runs.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from ssdn_tpu_torch.kernels import refuse_graph_cut
from ssdn_tpu_torch.numerics import precision_scope

#: Number of CUDA launches of K1 since the last reset (set it to 0 to reset).
launches = 0

_SIGNATURES = {
    "shifted_conv3x3_f32_halo": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_void_p],
    "shifted_conv3x3_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p],
}
_DTYPES = (torch.float32, torch.bfloat16)

#: One block's shared-memory limit on the H100 (bytes).
SMEM_LIMIT = 232_448
# csrc/shifted_conv.cu's geometry. fp32 (FMA): 256 threads of 8 pixels x 6
# output channels, tiles at most 16 pixels wide, a 3-stage ring of 32
# weight rows. bf16 (tensor cores): 8 warps of 32 pixels x 48 channels,
# tiles at most 64 pixels wide, shared rows padded by 8 bf16, a 2-stage
# weight ring.
_F32_THREADS, _F32_PIX, _F32_CH, _F32_MAX_TW = 256, 8, 6, 16
_F32_STAGES, _F32_KR = 3, 32
#: Shared memory of one H100 SM, and what CUDA reserves of it per block.
SM_SMEM, BLOCK_RESERVED = 228 * 1024, 1024
_TC_WARPS, _WARP_PX, _WARP_COLS, _MAX_TW, _SKEW, _STAGES = 8, 32, 48, 64, 8, 2
#: (Cin, Cout) pairs of the model: one pass over Cin, compile-time widths.
FIXED = ((48, 48), (96, 96), (48, 96))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """One K1 launch: the instantiation ("fma" for fp32; "fixed" or
    "generic" for bf16), the input channels staged per pass and the passes
    over Cin (fp32: over Cin rounded up to 4), the output channels per
    block and the blocks along Cout, the tile (tile_h rows x tile_w columns
    of the batch's rows), the tiles along the pixels, the threads and the
    shared bytes of a block; fp32 also the weight rows per ring stage (kr)
    and the blocks that share an SM (the default is the bf16 kernel's)."""
    instantiation: str
    cc: int
    passes: int
    cols: int
    col_blocks: int
    tile_h: int
    tile_w: int
    pixels: int
    tiles: int
    threads: int
    smem: int
    kr: int = 0
    blocks_per_sm: int = 2


def k1_plan(n: int, h: int, w: int, cin: int, cout: int,
            dtype: torch.dtype) -> K1Plan:
    """K1's launch plan for an (n, h, w, cin) input, cout output channels
    and x's dtype: the numbers the wrapper checks with and passes to the
    bf16 kernel, and that ``csrc/shifted_conv.cu`` computes the same way."""
    if dtype != torch.bfloat16:
        return _k1_plan_f32(n, h, w, cin, cout)
    fixed = (cin, cout) in FIXED
    if fixed:
        cc = cin
    elif cin <= 16:
        cc = 16
    elif cin % 48 == 0:
        cc = 48
    else:
        cc = 32
    wn = 1 if cout <= _WARP_COLS else 2
    px, cols = _TC_WARPS // wn * _WARP_PX, wn * _WARP_COLS
    tw = min(w, _MAX_TW)
    th = px // tw
    lda, ldb = cc + _SKEW, cols + _SKEW
    # bf16 elements: the halo'd tile (or the epilogue's rows over it), the
    # weight ring, the zero row
    smem = 2 * (max((th + 2) * (tw + 2) * lda, px * ldb)
                + _STAGES * cc * ldb + lda)
    return K1Plan("fixed" if fixed else "generic", cc, _cdiv(cin, cc), cols,
                  _cdiv(cout, cols), th, tw, px,
                  _cdiv(n * h, th) * _cdiv(w, tw), 32 * _TC_WARPS, smem)


def _f32_smem(cols: int, tw: int, th: int, cc: int) -> int:
    """fp32 K1's shared bytes: the halo'd tile ((th+2) x (tw+2) slots of
    cc channels, padded to an odd multiple of 4 floats), the weight ring
    and the zero row."""
    ldc = cc + 4 if cc % 8 == 0 else cc
    return 4 * ((th + 2) * (tw + 2) * ldc + _F32_STAGES * _F32_KR * cols
                + ldc)


def _k1_plan_f32(n, h, w, cin, cout) -> K1Plan:
    """fp32: 48 output channels and 256 pixels per block for Cout <= 48,
    else 96 and 128; a tile at most 16 wide; all of Cin (rounded up to 4)
    in one pass unless the halo'd tile would not fit one block, then the
    fewest passes that fit."""
    cols = 48 if cout <= 48 else 96
    px = _F32_PIX * _F32_THREADS // (cols // _F32_CH)
    tw = min(w, _F32_MAX_TW)
    th = px // tw
    cin4 = _cdiv(cin, 4) * 4
    passes, cc = 1, cin4
    while _f32_smem(cols, tw, th, cc) > SMEM_LIMIT and cc > 4:
        passes += 1
        cc = 4 * _cdiv(cin4, 4 * passes)
    smem = _f32_smem(cols, tw, th, cc)
    return K1Plan("fma", cc, _cdiv(cin4, cc), cols, _cdiv(cout, cols), th, tw,
                  px, _cdiv(n * h, th) * _cdiv(w, tw), _F32_THREADS, smem,
                  kr=_F32_KR, blocks_per_sm=2 if 2 * (smem + BLOCK_RESERVED) <= SM_SMEM
                  else 1)


def _check_k1_launch(plan: K1Plan) -> None:
    """What K1 takes beyond ``_check``: a block within the shared-memory
    limit, and a grid within CUDA's (2**31 - 1 tiles, 65,535 column
    blocks). Every shape the model produces is inside both."""
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"K1 needs {plan.smem} bytes of shared memory per "
                         f"block, more than {SMEM_LIMIT}")
    if plan.tiles > 2 ** 31 - 1 or plan.col_blocks > 65_535:
        raise ValueError(f"K1's grid ({plan.tiles} x {plan.col_blocks} "
                         "blocks) is over CUDA's limits")


def pack_weights(w: torch.Tensor, plan: K1Plan) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the bf16 kernel's (col_blocks, passes, 9, cc,
    cols) slices, zero-padded past Cin and Cout. At the model's pairs
    (``FIXED``) that is just (3, 3, Cin, Cout), with no padding."""
    cout, cin = w.shape[0], w.shape[1]
    wk = w.to(torch.bfloat16).permute(2, 3, 1, 0)  # (3, 3, Cin, Cout)
    if plan.instantiation == "fixed":
        return wk.contiguous()
    wk = F.pad(wk.reshape(9, cin, cout), (
        0, plan.col_blocks * plan.cols - cout, 0, plan.passes * plan.cc - cin))
    wk = wk.view(9, plan.passes, plan.cc, plan.col_blocks, plan.cols)
    return wk.permute(3, 1, 0, 2, 4).contiguous()


def pack_weights_f32(w: torch.Tensor, plan: K1Plan) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the fp32 kernel's (col_blocks, 9 * cin4, cols)
    rows, row k' = tap * cin4 + ci (cin4: Cin rounded up to 4), zero past
    Cin in each tap and past Cout. At the model's widths that is just (3,
    3, Cin, Cout), with no padding."""
    cout, cin = w.shape[0], w.shape[1]
    wk = w.to(torch.float32).permute(2, 3, 1, 0)  # (3, 3, Cin, Cout)
    cin4 = _cdiv(cin, 4) * 4
    if cin4 == cin and plan.col_blocks * plan.cols == cout:
        return wk.contiguous()
    wk = F.pad(wk.reshape(9, cin, cout),
               (0, plan.col_blocks * plan.cols - cout, 0, cin4 - cin))
    wk = wk.view(9, cin4, plan.col_blocks, plan.cols)
    return wk.permute(2, 0, 1, 3).contiguous().view(plan.col_blocks, 9 * cin4,
                                                    plan.cols)


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

    n, cin, h, wd = x.shape
    cout = w.shape[0]
    plan = k1_plan(n, h, wd, cin, cout, x.dtype)
    _check_k1_launch(plan)
    lib = _build.load("shifted_conv", _SIGNATURES)
    bias = b.to(torch.float32).contiguous()
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:
            wk = pack_weights(w, plan)
            err = lib.shifted_conv3x3_bf16(
                x.data_ptr(), wk.data_ptr(), bias.data_ptr(), y.data_ptr(),
                n, h, wd, cin, cout, plan.cc, plan.cols // _WARP_COLS,
                plan.tile_w, plan.tile_h, negative_slope, stream)
        else:
            wk = pack_weights_f32(w, plan)
            err = lib.shifted_conv3x3_f32_halo(
                x.data_ptr(), wk.data_ptr(), bias.data_ptr(), y.data_ptr(),
                n, h, wd, cin, cout, plan.cols, plan.tile_w, plan.tile_h,
                plan.cc, plan.kr, negative_slope, stream)
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
    with precision_scope(x.dtype, "highest"):
        dx = _conv_acc_f32(F.pad(dpre, (1, 1, 0, 2)), w_rot)
    with precision_scope(torch.float32, "highest"):  # true fp32, TF32 off
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
