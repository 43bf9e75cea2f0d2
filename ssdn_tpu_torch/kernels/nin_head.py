"""The fused 1x1 combiner head (port of the TPU kernels in
``ssdn_tpu/ops/pallas/nin_head.py``):

    h1  = lrelu(sum_i lrelu(x_i) @ Wa_i + ba)   rounded to x's dtype
    h2  = lrelu(h1 @ Wb + bb)                   rounded to x's dtype
    out = h2 @ Wc + bc                          fp32

The x_i are dec1b PRE-activations (the trunk runs with ``emit_preact``);
the branch concat is never built. Three kernels, each behind a wrapper
that launches it on CUDA tensors or raises, and computes its plain twin on
CPU tensors, and only there:

- K2 ``fused_nin_head`` / ``nin_head_fwd(save_h1=False)``: the forward for
  inference (``_fwd_call`` with ``save_h1=False``), ``csrc/nin_head.cu``;
  twin ``torch_reference``.
- K2' ``nin_head_fwd(save_h1=True)``: the same kernel, which also writes
  h1 (M, Na) in x's dtype for the backward (``_fwd_call`` as reached by
  ``_head_fwd``); twin ``torch_reference_fwd``.
- K3 ``nin_head_bwd``: the backward (``_bwd_call``),
  ``csrc/nin_head_bwd.cu``; twin ``torch_reference_bwd``.

``nin_head`` is the differentiable entry point (the JAX package's
``fused_nin_head`` custom VJP): an ``autograd.Function`` over K2' and K3
where autograd records, the K2 inference launch otherwise. Any M runs: the
TPU's ``_pick_tile`` divisibility rule has no counterpart (the kernels mask
a ragged tail).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch

from ssdn_tpu_torch.kernels import refuse_graph_cut

SLOPE = 0.1
MAX_BRANCHES = 4
# K3 only (both dtypes): layer-a columns. K2 walks Na in chunks and takes
# any Na (bf16: any multiple of 8).
MAX_NA = 512

#: CUDA launches since the last reset (set to 0 to reset): K2, the
#: inference forward; K2', the forward that saves h1; K3, the backward.
launches = 0
launches_save_h1 = 0
launches_bwd = 0

_SIGNATURES = {
    "nin_head_fwd": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "nin_head_bwd": [ctypes.c_void_p] * 21 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
# Row splits of K3's weight-grad reduction: a function of M alone, so two
# launches on the same inputs sum in the same order.
_SPLIT_ROWS = 4096
_MAX_SPLITS = 64
_DTYPES = (torch.float32, torch.bfloat16)

# K3's launch geometry; csrc/nin_head_bwd.cu uses the same numbers.
SMEM_LIMIT = 232_448     # bytes of shared memory one H100 block may use
_TILE_F32 = 64           # (b) fp32 output tile, square
_ROWS_TC = 64            # (a) rows per block, bf16 tensor-core kernel
_WA_CHUNK = 32           # (a) Wa_i columns per stage of its ring
_WA_STAGES = 4           # (a) the ring's stages
_TILE_P, _TILE_Q = 96, 128  # (b) bf16 output tile (P x Q)
_STAGE_ROWS = 32         # (b) bf16 rows per stage of its ring
_WG_STAGES = 4           # (b) the ring's stages
_SKEW = 8                # bf16 elements added to every shared row
_MAX_C_TC = 256          # (a) bf16: dx_i's columns all in one warp pass
# fp32 (a) on the FMA pipes, two launches: 128-row tiles, K in slices of
# 32, 256 threads, one block per SM. (a1) pre2 in passes of 96 columns of
# Nb, dh2's Nc in groups of 16, dh1 in chunks of 128 columns of Na, through a
# 3-stage ring; (a2) dx in chunks of 128 columns of k C, through a 2-stage
# ring. Shared floats: the ring (A slices of 32 columns, (a1) [row][k] with
# rows padded by 4, (a2) [k][row] with rows of 128 + 4; B slices up to 128
# wide) and, in (a1), the pass's dpre2 ([j][row]), g's group (two buffers,
# [row][n], rows padded by 4), Wc^T's group, and h1's signs for dpre1's mask
# (two buffers of one bit per row and column up to MAX_NA).
_K3F_ROWS, _K3F_SLICE, _K3F_THREADS = 128, 32, 256
_K3F_STAGES, _K3F_DX_STAGES = 3, 2
_K3F_PASS, _K3F_GROUP, _K3F_CHUNK, _K3F_DX_CHUNK = 96, 16, 128, 128
_K3F_LD = _K3F_ROWS + 4
_K3F_B = _K3F_SLICE * _K3F_CHUNK
_K3F_DX_SMEM = 4 * _K3F_DX_STAGES * (_K3F_SLICE * _K3F_LD + _K3F_B)
_K3F_ROWS_SMEM = 4 * (_K3F_STAGES * (_K3F_ROWS * (_K3F_SLICE + 4) + _K3F_B)
                      + _K3F_PASS * _K3F_LD
                      + 2 * _K3F_ROWS * (_K3F_GROUP + 4)
                      + _K3F_GROUP * _K3F_PASS) + 2 * _K3F_ROWS * MAX_NA // 8

# K2's launch geometry; csrc/nin_head.cu uses the same numbers. bf16 (tensor
# cores): 8 warps of 16 rows each, one block per SM, Na in chunks of 32
# columns through a 2-stage weight ring. The model's widths (k 4, C 96, Na
# 384, Nb 96) run an instantiation with them fixed at compile time, every
# other width a generic one.
_K2_WARPS, _K2_ROWS_PER_WARP, _K2_CHUNK, _K2_STAGES = 8, 16, 32, 2
_K2_MODEL = (4, 96, 384, 96)  # k, C, Na, Nb
_MAX_C_K2 = 256              # bf16: input channels
_MAX_NB_K2 = 128             # bf16: pre2's columns, held in registers
_NC_K2 = 16                  # bf16: out's columns, padded
# fp32 (FMA pipes): 128-row tiles, Na in chunks of 128 columns, layer a's K
# in slices of 32 channels through a 2-stage ring, pre2 in passes of 96
# columns (its registers), out in groups of 16 columns; 256 threads, one
# block per SM. Shared floats: x slices and Wa_i slices (2 stages each),
# the h1 chunk / h2 ([column][row], rows padded by 4), Wb[chunk, pass],
# Wc[pass, group].
_F32_ROWS, _F32_CHUNK, _F32_SLICE, _F32_STAGES = 128, 128, 32, 2
_F32_PASS, _F32_GROUP, _F32_THREADS = 96, 16, 256
_F32_LD = _F32_ROWS + 4
_F32_SMEM = 4 * (_F32_STAGES * _F32_SLICE * (_F32_LD + _F32_CHUNK)
                 + _F32_CHUNK * _F32_LD + _F32_CHUNK * _F32_PASS
                 + _F32_PASS * _F32_GROUP)


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """What one K2/K2' launch needs: the instantiation ("fma" for fp32;
    bf16: "fixed" at the model's widths, else "generic"), rows per tile,
    row tiles, Na's columns per chunk and chunks per tile, the weight
    ring's stages, passes over Nb (fp32: 96 columns of pre2 per pass),
    threads and blocks per SM (the grid is min(tiles, SMs x blocks per SM),
    persistent blocks), the shared bytes per block, and the bytes of Wa_i
    and Wb the blocks stream from L2 per launch (each tile reads them once
    per pass; Wc, read once per block, aside)."""
    instantiation: str
    rows_per_block: int
    row_tiles: int
    chunk: int
    chunks: int
    stages: int
    passes: int
    threads: int
    blocks_per_sm: int
    smem: int
    weight_bytes: int


def k2_plan(m: int, c: int, na: int, nb: int, nc: int, k: int,
            dtype: torch.dtype) -> K2Plan:
    """K2's launch plan for M rows, k branches of C channels, the head's
    widths Na, Nb, Nc and x's dtype: the numbers the wrapper checks with,
    and that ``csrc/nin_head.cu`` computes the same way."""
    if dtype != torch.bfloat16:
        rows, passes = _F32_ROWS, _cdiv(nb, _F32_PASS)
        tiles = _cdiv(m, rows)
        return K2Plan("fma", rows, tiles, _F32_CHUNK, _cdiv(na, _F32_CHUNK),
                      _F32_STAGES, passes, _F32_THREADS, 1, _F32_SMEM,
                      4 * tiles * (passes * k * c * na + na * nb))
    rows, chunk = _K2_ROWS_PER_WARP * _K2_WARPS, _K2_CHUNK
    p16 = lambda v: _cdiv(v, 16) * 16
    cp, nbp = p16(c), p16(nb)
    # bf16 elements: x tiles, the ring (Wa_i chunks | Wb chunk), the warps'
    # h1 chunk / h2 rows, Wc; every shared row padded by _SKEW
    smem = 2 * (k * rows * (cp + _SKEW)
                + _K2_STAGES * (k * cp * (chunk + _SKEW) + chunk * (nbp + _SKEW))
                + rows * (max(chunk, nbp) + _SKEW) + nbp * (_NC_K2 + _SKEW))
    inst = "fixed" if (k, c, na, nb) == _K2_MODEL else "generic"
    tiles = _cdiv(m, rows)
    return K2Plan(inst, rows, tiles, chunk, _cdiv(na, chunk), _K2_STAGES, 1,
                  32 * _K2_WARPS, 1, smem, 2 * tiles * (k * c * na + na * nb))


def _check_k2_launch(plan: K2Plan, tensors, c, na, nb, nc, dt) -> None:
    """What K2 takes beyond ``_check``: shared memory within one block's
    limit; fp32 (FMA): any widths, any alignment; bf16 (tensor cores): C,
    Na, Nb multiples of 8, C <= 256, Nb <= 128, Nc <= 16, and x_i, Wa_i,
    Wb on 16-byte boundaries (their rows move in 16-byte copies)."""
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"K2 needs {plan.smem} bytes of shared memory per "
                         f"block, more than {SMEM_LIMIT}")
    if dt != torch.bfloat16:
        return
    if c % 8 or na % 8 or nb % 8:
        raise ValueError(f"bf16 K2 takes C, Na, Nb in multiples of 8, got "
                         f"{c}, {na}, {nb}")
    if c > _MAX_C_K2:
        raise ValueError(f"bf16 K2 takes at most {_MAX_C_K2} input channels, "
                         f"got {c}")
    if nb > _MAX_NB_K2 or nc > _NC_K2:
        raise ValueError(f"bf16 K2 takes Nb <= {_MAX_NB_K2} and Nc <= "
                         f"{_NC_K2}, got {nb}, {nc}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("bf16 K2 operands must start on 16-byte boundaries")


@dataclasses.dataclass(frozen=True)
class K3RowLaunch:
    """One of fp32 K3 (a)'s two launches ("rows": pre2, dh2, dpre2, dh1 and
    dpre1; "dx": dx_i): rows per tile and row tiles (the grid is min(tiles,
    SMs x blocks per SM), persistent blocks), N's columns per chunk (rows:
    of Na; dx: of k C) and chunks per tile, K's slice and the ring's stages,
    passes over Nb, threads, blocks per SM, shared bytes per block, and the
    weight bytes the blocks stream from L2 per call (each tile reads its
    weights once; rows: Wb and Wb^T, dx: the k Wa_i^T; Wc aside)."""
    kernel: str
    rows_per_tile: int
    row_tiles: int
    chunk: int
    chunks: int
    slice: int
    stages: int
    passes: int
    threads: int
    blocks_per_sm: int
    smem: int
    weight_bytes: int


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """What one K3 launch needs: (a) rows per tile, row tiles and shared
    bytes per block (fp32: the larger of its two launches, described in
    ``row_launches``), (b) output tiles (blocks = tiles x splits) and
    shared bytes, the workspace (elements of x's dtype: h2, dpre2, dpre1
    and, in bf16, g rounded to bf16 and padded to 16 columns), the flat
    fp32 weight-grad sizes and the partial sums (floats)."""
    splits: int
    rows_per_block: int
    row_blocks: int
    rows_smem: int
    wgrad_tiles: int
    wgrad_smem: int
    workspace: int
    dw_sizes: tuple
    partial: int
    row_launches: tuple = ()

    @property
    def wgrad_blocks(self) -> int:
        return self.wgrad_tiles * self.splits


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k3_plan(m: int, c: int, na: int, nb: int, nc: int, k: int,
            dtype: torch.dtype) -> K3Plan:
    """K3's launch plan for M rows, k branches of C channels, the head's
    widths Na, Nb, Nc and x's dtype: the numbers the wrapper allocates and
    checks with, and that ``csrc/nin_head_bwd.cu`` computes the same way."""
    splits = bwd_splits(m)
    # flat fp32 output: [dWa_0 | dba | dWa_1.. | dWb | dbb | dWc | dbc]
    sizes = (c * na, na, *[c * na] * (k - 1), na * nb, nb, nb * nc, nc)
    if dtype == torch.bfloat16:
        p16 = lambda v: _cdiv(v, 16) * 16
        cp, nap, nbp, ncp = p16(c), p16(na), p16(nb), p16(nc)
        rows = _ROWS_TC
        smem = 2 * (nap * (nbp + _SKEW) + rows * (nap + _SKEW)
                    + rows * (max(nbp, cp) + _SKEW) + rows * (ncp + _SKEW)
                    + nbp * (ncp + _SKEW)
                    + _WA_STAGES * cp * (_WA_CHUNK + _SKEW))
        tq = _cdiv(na, _TILE_Q)
        # dWa_i (C x Na), dWb^T (Nb x Na), dWc (Nb x Nc), dbc's column sums
        tiles = (k * _cdiv(c, _TILE_P) * tq + _cdiv(nb, _TILE_P) * tq
                 + _cdiv(nb, _TILE_P) * _cdiv(nc, _TILE_Q) + 1)
        wsmem = _WG_STAGES * 2 * _STAGE_ROWS * (_TILE_P + _TILE_Q + 2 * _SKEW)
        ws = m * (2 * nb + na + ncp)
        launches = ()
    else:
        rows = _K3F_ROWS
        n_tiles = _cdiv(m, rows)
        launches = (
            K3RowLaunch("rows", rows, n_tiles, _K3F_CHUNK,
                        _cdiv(na, _K3F_CHUNK), _K3F_SLICE, _K3F_STAGES,
                        _cdiv(nb, _K3F_PASS), _K3F_THREADS, 1, _K3F_ROWS_SMEM,
                        4 * n_tiles * 2 * na * nb),
            K3RowLaunch("dx", rows, n_tiles, _K3F_DX_CHUNK,
                        _cdiv(k * c, _K3F_DX_CHUNK), _K3F_SLICE, _K3F_DX_STAGES,
                        1, _K3F_THREADS, 1, _K3F_DX_SMEM,
                        4 * n_tiles * k * c * na))
        smem = max(launch.smem for launch in launches)
        t = lambda p, q: _cdiv(p, _TILE_F32) * _cdiv(q, _TILE_F32)
        # dWa_0 + dba, dWa_i, dWb + dbb, dWc, dbc
        tiles = (t(c + 1, na) + (k - 1) * t(c, na) + t(na + 1, nb)
                 + t(nb, nc) + t(1, nc))
        wsmem = 2 * 4 * 32 * _TILE_F32
        ws = m * (2 * nb + na)
    return K3Plan(splits=splits, rows_per_block=rows,
                  row_blocks=_cdiv(m, rows), rows_smem=smem,
                  wgrad_tiles=tiles, wgrad_smem=wsmem,
                  workspace=ws, dw_sizes=sizes,
                  partial=splits * sum(sizes), row_launches=launches)


def _check_k3_launch(plan: K3Plan, tensors, c, na, nb, dt) -> None:
    """What the kernels take beyond ``_check``: Na <= ``MAX_NA``, shared
    memory within one block's limit (fp32: fixed, any widths and
    alignment) and, for the bf16 tensor-core kernels, widths C, Na, Nb
    that are multiples of 8 and operands on 16-byte boundaries (their
    rows move in 16-byte copies), and C <= ``_MAX_C_TC``."""
    if na > MAX_NA:
        raise ValueError(f"K3 supports at most {MAX_NA} layer-a columns, "
                         f"got {na}")
    if plan.rows_smem > SMEM_LIMIT:
        raise ValueError(f"K3 needs {plan.rows_smem} bytes of shared memory "
                         f"per block, more than {SMEM_LIMIT}")
    if dt != torch.bfloat16:
        return
    if c % 8 or na % 8 or nb % 8:
        raise ValueError(f"bf16 K3 takes C, Na, Nb in multiples of 8, got "
                         f"{c}, {na}, {nb}")
    if c > _MAX_C_TC:
        raise ValueError(f"bf16 K3 takes at most {_MAX_C_TC} input channels, "
                         f"got {c}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("bf16 K3 operands must start on 16-byte boundaries")


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    # the compare runs in fp32, as the TPU kernel's (-0.0 compares >= 0 and
    # keeps its value; both branches give -0.0 there)
    return torch.where(x.float() >= 0, x, SLOPE * x)


def torch_reference_fwd(xs: Sequence[torch.Tensor],
                        was: Sequence[torch.Tensor], ba, wb, bb, wc, bc):
    """Plain PyTorch twin of K2 / K2' with the kernel's rounding points:
    products accumulate in fp32 (upcasting bf16 operands first is exact),
    biases and LeakyReLU in fp32, h1 and h2 rounded once to x's dtype.
    Returns (out (M, Nc) fp32, h1 (M, Na) in x's dtype). In fp32 it is the
    JAX package's ``lax_reference``; in bf16 that oracle rounds each
    matmul before its bias add, the kernels round after it."""
    dt = xs[0].dtype
    acc = sum(_lrelu(x).float() @ wa.float() for x, wa in zip(xs, was))
    h1 = _lrelu(acc + ba.float()).to(dt)
    h2 = _lrelu(h1.float() @ wb.float() + bb.float()).to(dt)
    return h2.float() @ wc.float() + bc.float(), h1


def torch_reference(xs, was, ba, wb, bb, wc, bc) -> torch.Tensor:
    """The twin of K2 (inference): ``torch_reference_fwd``'s output."""
    return torch_reference_fwd(xs, was, ba, wb, bb, wc, bc)[0]


def torch_reference_bwd(xs: Sequence[torch.Tensor],
                        was: Sequence[torch.Tensor], h1, wb, bb, wc, g):
    """Plain PyTorch twin of K3, line by line the TPU kernel's
    ``_make_bwd_kernel``: returns (dxs in x's dtype, dWa_i, dba, dWb, dbb,
    dWc, dbc in fp32). g is the (M, Nc) fp32 cotangent; products
    accumulate in fp32 (upcasting bf16 operands is exact)."""
    dt = h1.dtype
    f = lambda t: t.float()
    g_lp = g.to(dt)
    pre2 = f(h1) @ f(wb) + f(bb)  # recomputed from the saved h1
    h2 = _lrelu(pre2).to(dt)
    dwc = f(h2).t() @ f(g_lp)
    dbc = g.float().sum(0)  # the fp32 g, as the TPU kernel sums it
    dh2 = f(g_lp) @ f(wc).t()
    dpre2 = torch.where(pre2 >= 0, dh2, SLOPE * dh2).to(dt)
    dwb = f(h1).t() @ f(dpre2)
    dbb = f(dpre2).sum(0)
    dh1 = f(dpre2) @ f(wb).t()
    dpre1 = torch.where(f(h1) >= 0, dh1, SLOPE * dh1).to(dt)
    dba = f(dpre1).sum(0)
    dxs, dwas = [], []
    for x, wa in zip(xs, was):
        dwas.append(f(_lrelu(x)).t() @ f(dpre1))
        dxi = f(dpre1) @ f(wa).t()
        dxs.append(torch.where(f(x) >= 0, dxi, SLOPE * dxi).to(dt))
    return dxs, dwas, dba, dwb, dbb, dwc, dbc


def _check(xs, was, ba, wb, bb, wc, bc, *, h1=None, g=None):
    k = len(xs)
    if not 1 <= k <= MAX_BRANCHES or len(was) != k:
        raise ValueError(f"K2/K3 take 1..{MAX_BRANCHES} branches, got {k}/{len(was)}")
    dt, dev = xs[0].dtype, xs[0].device
    if dt not in _DTYPES:
        raise TypeError(f"K2/K3 take float32 or bfloat16 input, got {dt}")
    m, c = xs[0].shape
    na, nb, nc = was[0].shape[1], wb.shape[1], wc.shape[1]
    shapes = [(x, (m, c), dt) for x in xs] + [(w, (c, na), dt) for w in was] + [
        (wb, (na, nb), dt), (bb, (nb,), torch.float32), (wc, (nb, nc), dt),
    ]
    if ba is not None:
        shapes += [(ba, (na,), torch.float32), (bc, (nc,), torch.float32)]
    if h1 is not None:
        shapes += [(h1, (m, na), dt), (g, (m, nc), torch.float32)]
    for t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"K2/K3 operand {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K2/K3 operands must be contiguous, on one device")
    if m == 0:
        raise ValueError("K2/K3 got an empty input")


def _on_cuda(x: torch.Tensor, kernel: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu tensors, not {x.device}")
    return True


def nin_head_fwd(xs: Sequence[torch.Tensor], was: Sequence[torch.Tensor],
                 ba, wb, bb, wc, bc, *, save_h1: bool):
    """K2 (``save_h1=False``) or K2' (``save_h1=True``): (out (M, Nc)
    fp32, h1 (M, Na) in x's dtype, or None).

    xs: 1..4 (M, C) tensors (fp32/bf16, pre-activations); was: matching
    (C, Na) row blocks of Wa in x's dtype; wb (Na, Nb) and wc (Nb, Nc) in
    x's dtype; ba/bb/bc fp32.
    """
    x0 = xs[0]
    if not _on_cuda(x0, "K2"):
        out, h1 = torch_reference_fwd(xs, was, ba, wb, bb, wc, bc)
        return out, (h1 if save_h1 else None)
    _check(xs, was, ba, wb, bb, wc, bc)
    refuse_graph_cut("K2 nin_head_fwd", *xs, *was, ba, wb, bb, wc, bc)
    from ssdn_tpu_torch.kernels import _build

    k = len(xs)
    m, c = x0.shape
    na, nb, nc = was[0].shape[1], wb.shape[1], wc.shape[1]
    plan = k2_plan(m, c, na, nb, nc, k, x0.dtype)
    _check_k2_launch(plan, (*xs, *was, wb), c, na, nb, nc, x0.dtype)
    lib = _build.load("nin_head", _SIGNATURES)
    out = torch.empty((m, nc), dtype=torch.float32, device=x0.device)
    h1 = (torch.empty((m, na), dtype=x0.dtype, device=x0.device)
          if save_h1 else None)
    pad = [None] * (MAX_BRANCHES - k)
    with torch.cuda.device(x0.device):
        err = lib.nin_head_fwd(
            *[x.data_ptr() for x in xs], *pad,
            *[w.data_ptr() for w in was], *pad,
            ba.data_ptr(), wb.data_ptr(), bb.data_ptr(), wc.data_ptr(),
            bc.data_ptr(), out.data_ptr(),
            h1.data_ptr() if save_h1 else None,
            k, m, c, na, nb, nc, SLOPE, int(x0.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"K2 nin_head_fwd launch failed: CUDA error {err}")
    global launches, launches_save_h1
    if save_h1:
        launches_save_h1 += 1
    else:
        launches += 1
    return out, h1


def fused_nin_head(xs: Sequence[torch.Tensor], was: Sequence[torch.Tensor],
                   ba, wb, bb, wc, bc) -> torch.Tensor:
    """K2, the inference forward: lrelu(lrelu(cat(xs)) @ cat(was) + ba) ->
    lrelu(@ wb + bb) -> @ wc + bc, (M, Nc) fp32 (operands as
    ``nin_head_fwd``)."""
    return nin_head_fwd(xs, was, ba, wb, bb, wc, bc, save_h1=False)[0]


def bwd_splits(m: int) -> int:
    """K3's row splits for M rows (a function of M alone)."""
    return max(1, min(_MAX_SPLITS, -(-m // _SPLIT_ROWS)))


def nin_head_bwd(xs: Sequence[torch.Tensor], was: Sequence[torch.Tensor],
                 h1, wb, bb, wc, g):
    """K3: the head backward. Returns (dxs in x's dtype, dWa_i, dba, dWb,
    dbb, dWc, dbc in fp32). h1 is K2''s saved (M, Na); g the (M, Nc) fp32
    cotangent; the rest as ``nin_head_fwd``."""
    x0 = xs[0]
    if not _on_cuda(x0, "K3"):
        return torch_reference_bwd(xs, was, h1, wb, bb, wc, g)
    _check(xs, was, None, wb, bb, wc, None, h1=h1, g=g)
    refuse_graph_cut("K3 nin_head_bwd", *xs, *was, h1, wb, bb, wc, g)
    from ssdn_tpu_torch.kernels import _build

    k = len(xs)
    m, c = x0.shape
    na, nb, nc = was[0].shape[1], wb.shape[1], wc.shape[1]
    dev, dt = x0.device, x0.dtype
    plan = k3_plan(m, c, na, nb, nc, k, dt)
    _check_k3_launch(plan, (*xs, *was, h1, wb, wc), c, na, nb, dt)
    lib = _build.load("nin_head_bwd", _BWD_SIGNATURES)
    dxs = [torch.empty_like(x) for x in xs]
    sizes = plan.dw_sizes
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    ws = torch.empty(plan.workspace, dtype=dt, device=dev)
    partial = torch.empty(plan.partial, dtype=torch.float32, device=dev)
    # the fp32 kernels stage slices of transposed weights (Wa_i^T for dx_i,
    # Wb^T for dh1); the bf16 kernel reads Wa_i and Wb as they are
    # (ldmatrix transposes in shared memory), so it takes no copies
    if dt == torch.bfloat16:
        wats, wbt = list(was), None
    else:
        wats = [w.t().contiguous() for w in was]
        wbt = wb.t().contiguous()
    pad = [None] * (MAX_BRANCHES - k)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.nin_head_bwd(
            *[x.data_ptr() for x in xs], *pad,
            *[ptr(w) for w in wats], *pad,
            h1.data_ptr(), wb.data_ptr(), ptr(wbt),
            bb.data_ptr(), wc.data_ptr(),
            g.data_ptr(), *[d.data_ptr() for d in dxs], *pad,
            dw.data_ptr(), ws.data_ptr(), partial.data_ptr(),
            k, m, c, na, nb, nc, plan.splits, SLOPE,
            int(dt == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"K3 nin_head_bwd launch failed: CUDA error {err}")
    global launches_bwd
    launches_bwd += 1
    parts = list(torch.split(dw, sizes))
    dwas = [parts[0].view(c, na)] + [p.view(c, na) for p in parts[2:k + 1]]
    dba = parts[1]
    dwb, dbb, dwc, dbc = parts[k + 1:]
    return dxs, dwas, dba, dwb.view(na, nb), dbb, dwc.view(nb, nc), dbc


class _FusedNinHead(torch.autograd.Function):
    """The JAX package's ``fused_nin_head`` custom VJP: forward K2' (saves
    h1), backward K3; the weight grads come back in the weights' own
    (compute) dtype, as ``_head_bwd`` casts them."""

    @staticmethod
    def forward(ctx, k, *args):
        xs, was = args[:k], args[k:2 * k]
        ba, wb, bb, wc, bc = args[2 * k:]
        out, h1 = nin_head_fwd(xs, was, ba, wb, bb, wc, bc, save_h1=True)
        ctx.save_for_backward(*xs, *was, h1, wb, bb, wc)
        ctx.k = k
        return out

    @staticmethod
    def backward(ctx, g):
        k = ctx.k
        saved = ctx.saved_tensors
        xs, was = saved[:k], saved[k:2 * k]
        h1, wb, bb, wc = saved[2 * k:]
        dxs, dwas, dba, dwb, dbb, dwc, dbc = nin_head_bwd(
            xs, was, h1, wb, bb, wc, g.float().contiguous())
        return (None, *dxs, *[d.to(w.dtype) for d, w in zip(dwas, was)],
                dba, dwb.to(wb.dtype), dbb, dwc.to(wc.dtype), dbc)


def nin_head(xs: Sequence[torch.Tensor], was: Sequence[torch.Tensor],
             ba, wb, bb, wc, bc) -> torch.Tensor:
    """Differentiable fused head (operands and output as ``fused_nin_head``).
    Where autograd records (grad mode on, an input requires grad) it runs
    the ``autograd.Function`` (K2' forward, K3 backward); otherwise the K2
    inference launch, which writes no h1."""
    args = (*xs, *was, ba, wb, bb, wc, bc)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedNinHead.apply(len(xs), *args)
    return fused_nin_head(xs, was, ba, wb, bb, wc, bc)
